"""The port stands alone: no file of ``src/repro_torch`` (nor ``chip_smoke.py``)
imports ``jax`` or the reference package, and its entry points run on the
CUDA card unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.core.ktuner import AdaptiveKSelector
from repro_torch.core.ksegments import KSegmentsConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import build, ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models.model import Transformer, init_cache, init_params
from repro_torch.serve.engine import greedy_generate, make_decode_step, make_prefill_step
from repro_torch.sim import traces
from repro_torch.sim import device_timeline
from repro_torch.sim.batch_engine import compute_cluster_ladders, simulate_grid, simulate_ksweep
from repro_torch.sim.cluster import run_cluster_batched, run_cluster_sweep
from repro_torch.sim.torch_sim import simulate_task_methods

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def _forbidden(name: str) -> bool:
    return any(name == root or name.startswith(root + ".") for root in ("jax", "jaxlib", "repro"))


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_neither_jax_nor_reference(path):
    bad = [n for n in _imported_modules(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_port_imports_with_jax_and_reference_blocked():
    """Importing every module of the port succeeds when jax and repro cannot be imported."""
    mods = sorted(
        ".".join(p.relative_to(REPO / "src").with_suffix("").parts).removesuffix(".__init__")
        for p in PORT_FILES
        if p.name != "chip_smoke.py"
    )
    code = "import sys\nfor m in ('jax', 'jaxlib', 'repro'): sys.modules[m] = None\n" + "".join(
        f"import {m}\n" for m in mods
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
                         env={**os.environ, "PYTHONPATH": str(REPO / "src")}, timeout=120)
    assert out.returncode == 0, out.stderr


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")


def test_default_device_raises_without_cuda():
    _no_cuda()
    wf = traces.generate_eager(seed=5, scale=0.12)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate_grid([wf])
    trace = max(wf.tasks, key=lambda t: t.n_executions)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate_ksweep(trace, (1, 2))
    x, y, lengths = trace.padded()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate_task_methods(x, y, lengths, trace.default_mib)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def _cluster_entry_points():
    """Each cluster entry point with small valid arguments."""
    import numpy as np

    wfs = [traces.generate_eager(seed=5, scale=0.12)]
    tasks = wfs[0].eligible_tasks(8)
    b, v = np.full((2, 1), np.inf), np.full((2, 1), 100.0)
    run = np.ones(2)
    lanes = [(b, v, run, run)]
    return {
        "run_cluster_batched": lambda **kw: run_cluster_batched(wfs, ("default",), **kw),
        "run_cluster_sweep": lambda **kw: run_cluster_sweep(wfs, ("default",), **kw),
        "compute_cluster_ladders": lambda **kw: compute_cluster_ladders(
            tasks, ("default",), 1024.0, KSegmentsConfig(error_mode="progressive"), **kw),
        "first_fit_window": lambda **kw: device_timeline.first_fit_window(
            0.0, b, v, run, run, [(np.zeros(0), np.zeros(1))], 1024.0, **kw),
        "schedule_epoch": lambda **kw: device_timeline.schedule_epoch(
            0.0, b, v, run, [(np.zeros(0), np.zeros(0))], np.zeros(0), 1024.0, **kw),
        "sweep_schedule": lambda **kw: device_timeline.sweep_schedule(lanes, [1], [1024.0], **kw),
    }


@pytest.mark.parametrize("name", sorted(_cluster_entry_points()))
def test_cluster_entry_points_need_cuda_unless_asked_for_cpu(name):
    """Without a card, a cluster entry point raises by default and runs
    only when the caller passes ``device="cpu"``."""
    _no_cuda()
    fn = _cluster_entry_points()[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()
    fn(device="cpu")


def _serving_entry_points():
    """Each serving entry point with small valid arguments."""
    cfg = get_config("llama3.2-3b").reduced()
    cpu_model = init_params(cfg, device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    return {
        "init_params": lambda **kw: init_params(cfg, **kw),
        "Transformer": lambda **kw: Transformer(cfg, seed=1, **kw),
        "init_cache": lambda **kw: init_cache(cfg, 1, 8, **kw),
        "greedy_generate": lambda **kw: greedy_generate(cpu_model, cfg, tokens, 2, **kw),
        "make_prefill_step": lambda **kw: make_prefill_step(cfg, 8, **kw)(cpu_model, {"tokens": tokens}),
        "make_decode_step": lambda **kw: make_decode_step(cfg, **kw),
        "launch.serve": lambda device=None: launch_serve.main(
            ["--requests", "2", "--decode-steps", "2"] + (["--device", device] if device else [])),
    }


@pytest.mark.parametrize("name", ["Transformer", "greedy_generate", "init_cache", "init_params", "launch.serve",
                                  "make_decode_step", "make_prefill_step"])
def test_serving_entry_points_need_cuda_unless_asked_for_cpu(name):
    """The language model's entry points and the launcher raise without a
    card by default and run when the caller passes ``device="cpu"``."""
    _no_cuda()
    fn = _serving_entry_points()[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()
    fn(device="cpu")


def test_adaptive_k_needs_cuda_unless_asked_for_cpu():
    """The tuner replays on the card by default; ``device="cpu"`` runs it here."""
    _no_cuda()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AdaptiveKSelector()
    sel = AdaptiveKSelector(candidates=(1, 2), refresh=4, min_history=4, device="cpu")
    for i in range(4):
        sel.observe(1e9 * (i + 1), [100.0 * (i + 1)] * 6)
    assert sel.history_k and sel.k in (1, 2)


def test_kernels_api_runs_where_its_tensors_lie():
    """The API has no device argument: CPU tensors take the plain versions
    (no launch), other devices have no kernel and raise."""
    before = ops.launch_counts()
    y = torch.rand((3, 8))
    kernels.segment_peaks(y, torch.full((3,), 8), 2)
    kernels.fit_stats(torch.rand(3), torch.rand((3, 2)), torch.ones(3))
    kernels.attempt_wastage(y, torch.full((3,), 8), torch.full((3, 1), 9.0), torch.full((3, 1), 1.0), 1.0)
    assert ops.launch_counts() == before
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        kernels.attempt_wastage(torch.zeros((2, 4), **meta), torch.ones(2, **meta), torch.ones((2, 1), **meta),
                                torch.ones((2, 1), **meta), 1.0)


def test_dispatch_has_no_fallback_for_other_devices():
    y = torch.zeros((2, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.segment_peaks(y, torch.ones(2, dtype=torch.int32, device="meta"),
                          torch.arange(2, dtype=torch.int32, device="meta"),
                          torch.ones(2, dtype=torch.int32, device="meta"), 2)


def test_every_kernel_source_is_built():
    assert sorted(build.SOURCES) == sorted(p.stem for p in build.CSRC.glob("*.cu"))
    for name in build.SOURCES:
        src = (build.CSRC / f"{name}.cu").read_text()
        assert f'extern "C" int {name}_launch(' in src
        # names the TPU kernel it replaces; scan, admission, admission_epoch,
        # moe_dispatch, moe_combine, rwkv_wkv and rglru_scan, which have
        # none, the reference's running sums, its admission scan, its carried
        # admission program, its MoE layer's dispatch and combine and its
        # recurrent mixers' recurrences
        no_tpu_kernel = {"scan": "repro/sim/jax_sim.py", "admission": "repro/sim/device_timeline.py",
                         "admission_epoch": "repro/sim/device_timeline.py",
                         "moe_dispatch": "repro/models/layers.py", "moe_combine": "repro/models/layers.py",
                         "rwkv_wkv": "repro/models/recurrent.py", "rglru_scan": "repro/models/recurrent.py"}
        assert f"repro/kernels/{name}.py" in src or (
            name in no_tpu_kernel and "No TPU kernel" in src and no_tpu_kernel[name] in src
        )
