"""The readers of the port's spans (`source: program_span`) on a
hand-built registry: each number from the spans it names, and None when
the registry lacks them or the port has no registry (an older port)."""

import os

import pytest

from conftest import BENCH
from perfbench import harness

READERS = ("krylov_device_ms.solve", "fine_level_device_ms.solve",
           "coarse_levels_device_ms.solve", "program_host_ms.solve",
           "program_capture_s.solve", "sa_galerkin_s",
           "k1_enqueue_us.matvec")


def _entry(calls=0, host_s=0.0, device_calls=0, device_s=0.0,
           self_device_s=0.0, parent=None):
    return {"calls": calls, "host_s": host_s, "device_calls": device_calls,
            "device_s": device_s, "self_device_s": self_device_s,
            "parent": parent}


# 13 traced replays of a solve with 9 cycles each; the set-up's and the
# traced run's captures; 512 traced K1 applies
REGISTRY = {
    "pcg": _entry(device_calls=13, device_s=0.169, self_device_s=0.026),
    "mg.cycle": _entry(device_calls=117, device_s=0.143,
                       self_device_s=0.0013, parent="pcg"),
    "mg.level0": _entry(device_calls=117, device_s=0.1417,
                        self_device_s=0.0780, parent="mg.cycle"),
    "mg.level1": _entry(device_calls=117, device_s=0.0637,
                        self_device_s=0.0390, parent="mg.level0"),
    "program.lookup": _entry(calls=14, host_s=14 * 40e-6),
    "program.inputs": _entry(calls=13, host_s=13 * 20e-6),
    "program.outputs": _entry(calls=13, host_s=13 * 30e-6),
    "program.warmup": _entry(calls=2, host_s=0.9),
    "program.capture": _entry(calls=2, host_s=0.3),
    "sa.galerkin": _entry(calls=6, host_s=2.5),
    "k1.launch": _entry(calls=512, host_s=512 * 25e-6),
}

WANT = {"krylov_device_ms.solve": 2.0, "fine_level_device_ms.solve": 6.0,
        "coarse_levels_device_ms.solve": 4.9,
        "program_host_ms.solve": 0.09, "program_capture_s.solve": 0.6,
        "sa_galerkin_s": 2.5, "k1_enqueue_us.matvec": 25.0}

# the spans each reader needs: without any one of them it reads None
NEEDS = {"krylov_device_ms.solve": ("pcg",),
         "fine_level_device_ms.solve": ("pcg", "mg.level0"),
         "coarse_levels_device_ms.solve": ("pcg", "mg.level1"),
         "program_host_ms.solve": ("program.lookup", "program.inputs",
                                   "program.outputs"),
         "program_capture_s.solve": ("program.warmup", "program.capture"),
         "sa_galerkin_s": ("sa.galerkin",),
         "k1_enqueue_us.matvec": ("k1.launch",)}


def _reader(name):
    return harness.load_module(os.path.join(BENCH, "metrics", name + ".py"),
                               "perfbench_metric_" + name.replace(".", "_"))


def _registry(monkeypatch, spans):
    from gnnla_tpu_torch.utils import program
    monkeypatch.setattr(program, "report", lambda: dict(spans))


def test_every_reader_is_declared_as_a_program_span():
    spec = harness.read_json(os.path.join(os.path.dirname(BENCH),
                                          "BENCHMARK.json"))
    decl = {m["name"]: m for m in spec["per_layer"]}
    assert set(READERS) <= set(decl)
    assert all(decl[name]["source"] == "program_span" for name in READERS)


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_its_spans(monkeypatch, name):
    _registry(monkeypatch, REGISTRY)
    assert _reader(name).read(None) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", READERS)
def test_reader_without_its_spans_reads_none(monkeypatch, name):
    read = _reader(name).read
    _registry(monkeypatch, {})
    assert read(None) is None
    for span in NEEDS[name]:
        _registry(monkeypatch, {k: v for k, v in REGISTRY.items()
                                if k != span})
        assert read(None) is None, span
    zeroed = {**REGISTRY, NEEDS[name][-1]: _entry()}
    _registry(monkeypatch, zeroed)
    assert read(None) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_of_a_port_with_no_registry_reads_none(monkeypatch, name):
    from gnnla_tpu_torch.utils import program
    monkeypatch.delattr(program, "report", raising=False)
    assert _reader(name).read(None) is None
