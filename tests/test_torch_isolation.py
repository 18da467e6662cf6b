"""The port stands alone: no file of src/repro_torch/ nor chip_smoke.py
nor the port's examples imports jax, ml_dtypes (numpy's bfloat16, which jax
brings) or anything of repro; every port module imports with all of them
blocked; entry points refuse to run on the CPU unless asked to; the serve
and train launchers take the reference's data-plane flags (the transports,
striped channels, coalescing, the staging pool with tenancy, fault plans)
and stage through each, and refuse only what the port does not take (a
malformed mesh, a model axis that divides neither the heads nor the padded
heads); the quickstart twin runs on the CPU; chip_smoke.py fails without a
GPU and outside a checkout."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "examples" / "torch_simulation_intransit.py",
    ROOT / "examples" / "torch_train_with_intransit.py",
    ROOT / "examples" / "torch_quickstart.py",
    ROOT / "examples" / "torch_serve_batched.py"]
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
            roots.add(node.args[0].value.split(".")[0])
    return roots


def _port_modules() -> list[str]:
    mods = []
    for f in sorted(PORT.rglob("*.py")):
        parts = f.relative_to(PORT.parent).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return mods


def test_port_files_import_neither_jax_nor_repro():
    assert len(PORT_FILES) > 10
    for name in ("dryrun.py", "op_analysis.py"):     # the dry run's modules
        assert PORT / "launch" / name in PORT_FILES
    bad = {str(f.relative_to(ROOT)): sorted(_imported_roots(f) & set(FORBIDDEN))
           for f in PORT_FILES}
    assert not {f: r for f, r in bad.items() if r}


def test_every_port_module_imports_with_jax_and_repro_blocked():
    """jax, jaxlib, ml_dtypes and repro blocked."""
    mods = _port_modules()
    assert "repro_torch.launch.serve" in mods and "repro_torch.convert" in mods
    assert "repro_torch.launch.train" in mods
    prog = (
        "import importlib, sys\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not [m for m in sys.modules if m.startswith(\n"
        "    ('jax.', 'repro.', 'ml_dtypes.'))]\n"
        f"print('imported', {len(mods)})\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", prog], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert f"imported {len(mods)}" in r.stdout


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_launch
    from repro_torch.launch.serve import serve
    from repro_torch.models import Model
    from repro_torch.train import TrainSetup

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("gemma2-27b").smoke()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve(cfg, batch=1, prompt_len=4, new_tokens=1, log=lambda m: None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(cfg).init(seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrainSetup(Model(cfg)).init_state(seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_launch.main(["--arch", "gemma2-27b", "--smoke", "--steps", "1"])
    res = serve(cfg, batch=1, prompt_len=4, new_tokens=2, device="cpu",
                log=lambda m: None)
    assert res["tokens"].shape == (1, 2)
    logs = []
    out = train_launch.train(train_launch.build_parser().parse_args(
        ["--arch", "gemma2-27b", "--smoke", "--device", "cpu", "--steps", "2",
         "--seq", "16", "--batch", "2"]), log=logs.append)
    assert len(out["metrics"]) == 2 and "on cpu" in logs[0]


def test_serve_cli_rejects_a_mesh(capsys):
    """A mesh string that names no mesh: argparse's exit code 2 before
    anything runs (serving on a mesh: tests/test_torch_tensor_parallel.py;
    the production meshes raise without their 256 and 512 ranks)."""
    from repro_torch.launch.serve import main
    for bad in ("--mesh=2x", "--mesh=2x0", "--mesh=2x2x2x2"):
        with pytest.raises(SystemExit) as e:
            main(["--arch", "gemma2-27b", "--smoke", "--device", "cpu", bad])
        assert e.value.code == 2
        assert "want DxM, PxDxM, single or multi" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="need 256 devices"):
        main(["--arch", "gemma2-27b", "--smoke", "--device", "cpu",
              "--mesh=single"])


@pytest.fixture()
def recorded(monkeypatch):
    """The sinks and staging servers the launchers make, kept for reading
    after they stop."""
    import repro_torch.core as pcore
    made = {"sinks": [], "stagings": []}

    class Sink(pcore.InTransitSink):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made["sinks"].append(self)

    class Staging(pcore.StagingServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made["stagings"].append(self)

    monkeypatch.setattr(pcore, "InTransitSink", Sink)
    monkeypatch.setattr(pcore, "StagingServer", Staging)
    return made


SERVE_FLAGS = {
    "mesh": ["--mesh=1x1"],
    "channels": ["--channels=2"],
    "coalesce": ["--coalesce-kb=64"],
    "pool": ["--pool=2", "--tenant=alice:tok", "--quota-mb=1"],
    "faults": ["--channels=2", "--faults=seed=1;drop:op=stripe,nth=2"],
    **{e: [f"--transport={e}"] for e in ("scp_mem", "scp_disk", "ssh_direct")},
}


@pytest.mark.parametrize("case", list(SERVE_FLAGS))
def test_serve_cli_stages_through_each_data_plane_flag(case, recorded, capsys):
    """Each of the reference's data-plane flags runs on the CPU and the
    decode latencies reach SAVIME through the feature it names."""
    from repro_torch.launch.serve import main
    main(["--arch", "gemma2-27b", "--smoke", "--device", "cpu", "--batch", "1",
          "--prompt-len", "8", "--new-tokens", "4", "--intransit",
          "--codec", "int8-block", "--analyzer", "running_stats",
          *SERVE_FLAGS[case]])
    out = capsys.readouterr().out
    assert "analyzer[running_stats] over (3, 1) staged latencies" in out
    assert "'count': 3" in out
    (sink,) = recorded["sinks"]
    stats = sink.session.stats
    assert stats.n_datasets == 3
    if case in ("channels", "faults"):
        assert len(stats.channels) == 2
        assert sum(c["n_stripes"] for c in stats.channels) == 3
    if case == "faults":
        assert "fault plan armed (seed=1, 1 rule(s))" in out
        assert sum(c["adopted"] for c in stats.channels) >= 1
    if case == "coalesce":
        (st,) = recorded["stagings"]
        assert st.stats["batched_datasets"] == 3
    if case == "pool":
        assert "staging pool: 2 backends" in out
        assert stats.gateway["tenants"]["alice"]["datasets"] == 3
        assert stats.gateway["tenants"]["alice"]["quota_bytes"] == 1 << 20
    if case in ("scp_mem", "scp_disk", "ssh_direct"):
        assert stats.engine == case and stats.codec == {}
    else:
        assert stats.codec["datasets"] == 3


@pytest.mark.parametrize("flags,why", [
    (["--tenant=a"], "--tenant/--quota-mb require --pool"),
    (["--pool=2", "--transport=scp_mem"], "--pool requires the rdma_staged"),
    (["--analyzer=histogram"], "--analyzer requires --intransit")])
def test_serve_cli_checks_flags_as_the_reference(flags, why, capsys):
    from repro_torch.launch.serve import main
    with pytest.raises(SystemExit) as e:
        main(["--arch", "gemma2-27b", "--smoke", "--device", "cpu", *flags])
    assert e.value.code == 2
    assert why in capsys.readouterr().err


@pytest.mark.parametrize("flag,why", [
    ("--mesh=2x", "want DxM, PxDxM"),
    ("--mesh=1x3", "divides neither n_heads 4 nor pad_heads_to 0")])
def test_train_cli_rejects_multi_device_flags(flag, why, capsys):
    """The train meshes the launcher refuses: a malformed string, and a
    model axis that divides neither the smoke config's 4 heads nor its
    pad_heads_to. Each exits with argparse's code 2 before anything runs
    (DP and TP meshes and --compress-pods run:
    tests/test_torch_distributed.py, tests/test_torch_tp_train.py)."""
    from repro_torch.launch.train import main
    with pytest.raises(SystemExit) as e:
        main(["--arch", "gemma2-27b", "--smoke", "--device", "cpu", flag])
    assert e.value.code == 2
    assert why in capsys.readouterr().err


TRAIN_FLAGS = {
    "channels+coalesce": ["--channels=2", "--coalesce-kb=64"],
    "faults": ["--channels=2", "--coalesce-kb=64",
               "--faults=seed=7;drop:op=batch_write,nth=2"],
    **{e: [f"--transport={e}"] for e in ("scp_mem", "scp_disk", "ssh_direct")},
}


@pytest.mark.parametrize("case", list(TRAIN_FLAGS))
def test_train_cli_stages_through_each_data_plane_flag(case, tmp_path, capsys):
    """The train launcher with each of the reference's data-plane flags on
    the CPU: the loss falls and SAVIME holds every step's diagnostics,
    staged through the feature the flag names."""
    from repro_torch.launch.train import main
    out = main(["--arch", "gemma2-27b", "--smoke", "--device", "cpu",
                "--steps", "6", "--seq", "16", "--batch", "2", "--ckpt-every",
                "3", "--ckpt-dir", str(tmp_path), "--intransit", "--egress",
                "grads_int8", *TRAIN_FLAGS[case]])
    losses = [m["loss"] for m in out["metrics"]]
    assert losses[-1] < losses[0] and out["diag"].shape == (6, 2)
    np.testing.assert_allclose(out["diag"][:, 0], losses, rtol=1e-6)
    t, st = out["transfer"], out["staging"]
    if case == "channels+coalesce":
        # the step egress (diag, int8 blocks, scales: 3 datasets a step,
        # each below 64 KiB) rides coalesced frames, the checkpoints'
        # larger leaves the stripes
        assert len(t["channels"]) == 2
        assert st["stripes"] > 0 and st["batched_datasets"] >= 6 * 3
    if case == "faults":
        # the dropped batch_write fails its batch; the journal replays each
        # of its datasets on its own, past the coalescer
        assert "fault plan armed (seed=7, 1 rule(s))" in capsys.readouterr().out
        assert t["replays"] >= 1 and st["stripes"] > 0
    if case in ("scp_mem", "scp_disk", "ssh_direct"):
        assert t["engine"] == case and st["datasets"] == 0


@pytest.mark.parametrize("codec", ["int8-block", "none"])
def test_serve_cli_stages_decode_latencies_in_transit(codec, capsys):
    """--intransit stages each decode step's latency through the port's
    sink, staging and SAVIME; the analyzer reads them back."""
    from repro_torch.launch.serve import main
    main(["--arch", "gemma2-27b", "--smoke", "--device", "cpu", "--batch", "1",
          "--prompt-len", "8", "--new-tokens", "4", "--intransit",
          "--codec", codec, "--analyzer", "running_stats"])
    out = capsys.readouterr().out
    assert "analyzer[running_stats] over (3, 1) staged latencies" in out
    assert "'count': 3" in out


def test_serve_cli_runs_on_the_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", "gemma2-27b", "--smoke", "--device", "cpu", "--batch", "2",
          "--prompt-len", "40", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "gemma2-27b-smoke" in out and "decode p50" in out


def test_serve_module_runs_falcon_mamba_on_the_cpu():
    """``python -m repro_torch.launch.serve --arch falcon-mamba-7b --smoke
    --device cpu``, as a user would run it, with jax and repro blocked."""
    prog = ("import runpy, sys\n"
            f"for name in {FORBIDDEN!r}:\n"
            "    sys.modules[name] = None\n"
            "sys.argv = ['serve', '--arch', 'falcon-mamba-7b', '--smoke',\n"
            "            '--device', 'cpu', '--prompt-len', '24',\n"
            "            '--new-tokens', '3']\n"
            "runpy.run_module('repro_torch.launch.serve', run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", prog], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "falcon-mamba-7b-smoke" in r.stdout and "decode p50" in r.stdout


ARCH_IDS = ("llama4-maverick-400b-a17b", "arctic-480b", "recurrentgemma-9b",
            "musicgen-medium", "paligemma-3b", "qwen2-72b", "granite-34b",
            "gemma2-27b", "gemma3-4b", "falcon-mamba-7b")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_cli_runs_every_architecture_on_the_cpu(arch, capsys):
    """``--arch <id> --smoke --device cpu`` for each of the reference's ten
    architectures (a 36-token prompt: past the smoke window of 32)."""
    from repro_torch.configs import ARCH_IDS as registered
    from repro_torch.launch.serve import main
    assert set(registered) == set(ARCH_IDS)
    main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
          "--prompt-len", "36", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert f"{arch}-smoke" in out and "decode p50" in out


def test_serve_batched_twin_runs_on_the_cpu_without_jax():
    """``examples/torch_serve_batched.py --device cpu`` (qwen2-72b smoke)
    with jax, ml_dtypes and repro blocked ends with ``OK``, as the
    reference's serve_batched.py does."""
    prog = ("import runpy, sys\n"
            f"for name in {FORBIDDEN!r}:\n"
            "    sys.modules[name] = None\n"
            "sys.argv = ['serve_batched', '--device', 'cpu']\n"
            f"runpy.run_path({str(ROOT / 'examples' / 'torch_serve_batched.py')!r},"
            " run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", prog], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-4000:]
    assert r.stdout.splitlines()[-1] == "OK"
    assert "generated token ids (batch 0)" in r.stdout


def test_quickstart_twin_runs_on_the_cpu_without_jax():
    """``examples/torch_quickstart.py --device cpu --smoke`` with jax,
    ml_dtypes and repro blocked: Listing 1 with the field as a tensor, the
    typed queries and the 3-backend pool all assert, and it ends with
    ``OK`` as the reference's quickstart does."""
    prog = ("import runpy, sys\n"
            f"for name in {FORBIDDEN!r}:\n"
            "    sys.modules[name] = None\n"
            "sys.argv = ['quickstart', '--device', 'cpu', '--smoke']\n"
            f"runpy.run_path({str(ROOT / 'examples' / 'torch_quickstart.py')!r},"
            " run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", prog], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-4000:]
    assert r.stdout.splitlines()[-1] == "OK"
    assert "pool: 6 datasets sharded over 3 backends" in r.stdout


def _run_smoke(cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_gpu():
    r = _run_smoke(ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_smoke(tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
