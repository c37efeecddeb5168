"""Kernels K7 and K8, the gather probes — the counterparts of
scratch/probe_dyngather.py, which measured how fast the TPU gathers inside
a kernel (`tpu.dynamic_gather`) while the general-graph SpMV was designed.

  * K7, `probe_axis1`: out[b, r, l] = win[128 * hi + lo] * vals, a window
    win f32 [W = 128 * n_chunks] and lo, hi int32, vals f32 [B, R, 128].
  * K8, `probe_axis0`: out[b, r, l] = win[idx[b, r, l], l], win f32
    [R, 128] and idx int32 [B, R, 128].

`axis1_plain`, `axis0_plain` are the plain PyTorch versions; `axis1_cuda`,
`axis0_cuda` the raw launches (`csrc/gather_probe.cu`); `GatherProbe` the
wrapper that picks one or the other by the tensors' device and counts the
launches. K8 gathers from lane slabs (each block stages the 32 columns of
win its lanes read) while a slab takes at most GATHER_SLAB_BYTES, else
reads win through the read-only cache; its earlier design, the whole
window in shared memory, stays callable by the raw launch for comparison.
"""

from __future__ import annotations

import torch

from gnnla_tpu_torch import _build

LANES = 128
SLAB_LANES = 32  # the lanes of one K8 block: a warp's width
# K8's lane slab (R * 32 * 4 bytes) goes to shared memory up to this many
# bytes, the most a block can opt in to: R <= 1,816 rows. K7's window
# always does (128 * n_chunks * 4 bytes, 16 KB at the probe's widest).
GATHER_SLAB_BYTES = 227 * 1024
# K8's paths and the mode numbers csrc/gather_probe.cu takes for them;
# "window" (all of win in shared memory) is the earlier design, which no
# wrapper picks
AXIS0_MODES = {"read-only cache": 0, "window": 1, "slab": 2}


def axis1_plain(win: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                vals: torch.Tensor) -> torch.Tensor:
    """K7's plain version: win[128 * hi + lo] * vals."""
    return torch.take(win, (hi.long() * LANES + lo.long())) * vals


def axis0_plain(win: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K8's plain version: out[..., l] = win[idx[..., l], l]."""
    lane = torch.arange(LANES, device=idx.device)
    return win[idx.long(), lane]


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"gather_probe: {msg}")


def _check(tensors, out_shape, what: str) -> None:
    dev = tensors[0].device
    _require(dev.type == "cuda", f"{what}: inputs lie on {dev}, not CUDA")
    _require(all(t.device == dev and t.is_contiguous()
                 and t.data_ptr() % 16 == 0 for t in tensors),
             f"{what}: inputs must be contiguous, 16-byte aligned and on "
             "one device")
    _require(len(out_shape) >= 1 and out_shape[-1] == LANES,
             f"{what}: the last dimension must be {LANES}, not "
             f"{tuple(out_shape)}")


def axis1_cuda(win: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
               vals: torch.Tensor) -> torch.Tensor:
    """Launch K7 (every 128 * hi + lo must lie in [0, win.numel()))."""
    _check((win, lo, hi, vals), lo.shape, "probe_axis1")
    _require(win.ndim == 1 and win.numel() % LANES == 0
             and win.dtype == vals.dtype == torch.float32
             and lo.dtype == hi.dtype == torch.int32
             and lo.shape == hi.shape == vals.shape,
             "probe_axis1: win f32 [128 * n_chunks], lo, hi int32 and vals "
             "f32 of one shape [..., 128]")
    out = torch.empty_like(vals)
    lib = _build.load()
    with torch.cuda.device(win.device):
        stream = torch.cuda.current_stream(win.device).cuda_stream
        _build.check(lib.gather_axis1_f32(
            win.data_ptr(), win.numel(), lo.data_ptr(), hi.data_ptr(),
            vals.data_ptr(), out.data_ptr(), out.numel(), stream),
            "gather_axis1_f32")
    return out


def axis0_path(R: int) -> str:
    """K8's path for a window of R rows: "slab" while a lane slab fits a
    block's shared memory, else "read-only cache"."""
    return ("slab" if R * SLAB_LANES * 4 <= GATHER_SLAB_BYTES
            else "read-only cache")


def axis0_cuda(win: torch.Tensor, idx: torch.Tensor,
               path: str = None) -> torch.Tensor:
    """Launch K8 (every idx must lie in [0, R)) on `path`, by default
    `axis0_path(R)`; "window" launches the earlier design (R * 512 bytes
    of shared memory)."""
    _check((win, idx), idx.shape, "probe_axis0")
    _require(win.ndim == 2 and win.shape[1] == LANES
             and win.dtype == torch.float32 and idx.dtype == torch.int32,
             "probe_axis0: win f32 [R, 128] and idx int32 [..., 128]")
    path = axis0_path(win.shape[0]) if path is None else path
    _require(path in AXIS0_MODES, f"probe_axis0: path {path!r} is not one "
             f"of {sorted(AXIS0_MODES)}")
    out = torch.empty(idx.shape, dtype=torch.float32, device=idx.device)
    lib = _build.load()
    with torch.cuda.device(win.device):
        stream = torch.cuda.current_stream(win.device).cuda_stream
        _build.check(lib.gather_axis0_f32(
            win.data_ptr(), win.shape[0], idx.data_ptr(), out.data_ptr(),
            out.numel(), AXIS0_MODES[path], stream),
            "gather_axis0_f32")
    return out


class GatherProbe:
    """K7 (`axis1`) and K8 (`axis0`) on CUDA tensors, each launch counted
    in `launches["axis1"]` or `launches["axis0"]`; the plain versions on
    CPU tensors, uncounted."""

    def __init__(self):
        self.launches = {"axis1": 0, "axis0": 0}

    def axis1(self, win, lo, hi, vals) -> torch.Tensor:
        if win.device.type == "cpu":
            return axis1_plain(win, lo, hi, vals)
        out = axis1_cuda(win, lo, hi, vals)
        self.launches["axis1"] += 1
        return out

    def axis0(self, win, idx) -> torch.Tensor:
        if win.device.type == "cpu":
            return axis0_plain(win, idx)
        out = axis0_cuda(win, idx)
        self.launches["axis0"] += 1
        return out
