"""Render PERF.md's H100 results block from the port's committed results
— the twin of the JAX repository's scripts/gen_perf_results.py.

The block between the H100 markers is rendered from the JSONs under
`artifacts_torch/` (the `gnnla_tpu_torch.scripts` twins' results from a
run on the card, committed verbatim); `tests/test_torch_artifacts.py`
fails when PERF.md and those JSONs disagree. The JAX package's RESULTS
block, between its own markers, is never touched.

Usage: python -m gnnla_tpu_torch.scripts.gen_results   # rewrites PERF.md
"""

from __future__ import annotations

import json
import os
import sys

from gnnla_tpu_torch.scripts._common import ROOT

BEGIN = ("<!-- BEGIN GENERATED H100 RESULTS "
         "(gnnla_tpu_torch/scripts/gen_results.py) -->")
END = "<!-- END GENERATED H100 RESULTS -->"
RESULTS = os.path.join(ROOT, "artifacts_torch")


def _load(rel):
    path = os.path.join(RESULTS, rel)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _ed(v):
    return f"({v[0]},{v[1]})" if v and v[0] else "—"


def render() -> str:
    """The H100 block's text (marker to marker, exclusive)."""
    jr = _load("jacobi/results.json")
    js = _load("jacobi/results_stable.json")
    sm = _load("jacobi/smoother_twogrid.json")
    dr = _load("diffusion/results.json")
    grid = _load("diffusion/grid.json")

    out = []
    a = out.append
    a("")
    a("The twins' printed result lines at the JAX scripts' defaults "
      "(`artifacts_torch/`, held by")
    a("`tests/test_torch_artifacts.py`), each with the card it ran on.")
    a("")
    if jr:
        c, hf, fs = (jr["config"], jr["highfreq_damping_mean"],
                     jr["fullspectrum_damping_mean"])
        head = (f"**Trainable Jacobi** ({jr['device']}; {c['num_matrices']} "
                f"small-band matrices, {c['epochs']} epochs, batch "
                f"{c['batch_size']}, seed {c['seed']}; exact eigen analysis "
                f"over {jr['n_test_matrices']} test matrices; training "
                f"{jr['train_seconds']:.0f} s")
        if js:
            head += (f"; the stable D: {js['config']['epochs']} epochs "
                     f"warm-started, weight "
                     f"{js['config']['stability_weight']}, margin "
                     f"{js['config']['stability_margin']}, "
                     f"{js['train_seconds']:.0f} s, {js['device']}")
        if sm:
            head += (f"; cycle ρ: 1 pre + 1 post sweep, exact coarse solve, "
                     f"{sm['n_matrices']} test matrices, {sm['device']}")
        a(head + "):")
        a("")
        def rho(k):
            return f"{sm[k]:.3f}" if sm and k in sm else "—"

        a("| Diagonal | mean high-freq damping | mean full-spectrum damping "
          "| mean cycle ρ (max) |")
        a("|---|---|---|---|")
        a(f"| **learned D** | **{hf['learned']:.3f}** | {fs['learned']:.3f} "
          f"| {rho('convfac_learned_mean')} ({rho('convfac_learned_max')}) |")
        if js:
            hs, ss = (js["highfreq_damping_mean"],
                      js["fullspectrum_damping_mean"])
            a(f"| stable D | {hs['learned']:.3f} | {ss['learned']:.3f} | "
              f"{rho('convfac_stable_mean')} ({rho('convfac_stable_max')}) |")
        a(f"| ω = 1 | {hf['w1']:.3f} | {fs['w1']:.3f} | — |")
        a(f"| ω = 2/3 | {hf['w23']:.3f} | {fs['w23']:.3f} | "
          f"{rho('convfac_w23_mean')} ({rho('convfac_w23_max')}) |")
        a(f"| ω_opt (per-matrix optimal) | {hf['opt']:.3f} | "
          f"{fs['opt']:.3f} | — |")
        a("")
    if dr:
        c, ood = dr["config"], dr["ood_loss_by_decade"]
        decs = sorted(ood, key=lambda k: -float(k))
        a(f"**Diffusion-coefficient recovery** ({dr['device']}; "
          f"n_mesh={c['n_mesh']}, {c['num_matrices']} matrices, "
          f"{c['n_layers_external']}-ext/{c['n_layers_internal']}-int/"
          f"{c['n_hidden']}-hidden/enc({c['encoder'][0]},"
          f"{c['encoder'][1]})): test loss **{dr['test_loss']:.5f}**; OOD "
          f"across α decades {decs[0]}→{decs[-1]} "
          f"({ood[decs[0]]:.4f}→{ood[decs[-1]]:.4f}); frequency-study mean "
          f"err {dr['freq_study_mean_err']:.4f} / max "
          f"{dr['freq_study_max_err']:.3f}; training "
          f"{dr['train_seconds']:.0f} s ({dr['epochs_run']} epochs, "
          "early-stopped).")
        a("")
    if grid:
        g = grid["config"]
        a(f"**Hyperparameter grid** ({grid['device']}; the top-"
          f"{len(grid['combos'])} combinations, {g['num_matrices']} "
          f"matrices at n = {g['n_mesh']}, {g['epochs']} epochs, patience "
          f"{g['patience']}):")
        a("")
        a("| ext | int | hidden | encoder | decoder | val loss | test loss "
          "| epochs | s |")
        a("|---|---|---|---|---|---|---|---|---|")
        for j, cb in enumerate(grid["combos"]):
            star = " ★" if j == grid["best_index"] else ""
            a(f"| {cb['n_layers_external']} | {cb['n_layers_internal']} | "
              f"{cb['n_hidden']} | {_ed(cb['encoder'])} | "
              f"{_ed(cb['decoder'])} | {cb['val_loss']:.5f}{star} | "
              f"{cb['test_loss']:.5f} | {cb['epochs_run']} | "
              f"{cb['train_seconds']:.0f} |")
        a("")
        bi = grid["combos"][grid["best_index"]]
        a(f"Selected (lowest val loss): combination #"
          f"{grid['best_index'] + 1} (val {bi['val_loss']:.5f}).")
        a("")
    return "\n".join(out)


def main() -> int:
    path = os.path.join(ROOT, "PERF.md")
    with open(path) as f:
        text = f.read()
    if BEGIN not in text or END not in text:
        print("PERF.md H100 markers missing", file=sys.stderr)
        return 1
    head, rest = text.split(BEGIN, 1)
    _, tail = rest.split(END, 1)
    with open(path, "w") as f:
        f.write(head + BEGIN + "\n" + render() + END + tail)
    print("PERF.md H100 results regenerated")
    return 0


if __name__ == "__main__":
    sys.exit(main())
