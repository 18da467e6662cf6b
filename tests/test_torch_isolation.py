"""The port stands alone: no file of src/repro_torch/ nor chip_smoke.py
imports jax or anything of repro; every port module imports with both
blocked; entry points refuse to run on the CPU unless asked to; the serve
launcher rejects the reference's data-plane flags; chip_smoke.py fails
without a GPU and outside a checkout."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


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
    bad = {str(f.relative_to(ROOT)): sorted(_imported_roots(f) & set(FORBIDDEN))
           for f in PORT_FILES}
    assert not {f: r for f, r in bad.items() if r}


def test_every_port_module_imports_with_jax_and_repro_blocked():
    mods = _port_modules()
    assert "repro_torch.launch.serve" in mods and "repro_torch.convert" in mods
    prog = (
        "import importlib, sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not [m for m in sys.modules if m.startswith(('jax.', 'repro.'))]\n"
        f"print('imported', {len(mods)})\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", prog], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert f"imported {len(mods)}" in r.stdout


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import Model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("gemma2-27b").smoke()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve(cfg, batch=1, prompt_len=4, new_tokens=1, log=lambda m: None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(cfg).init(seed=0)
    res = serve(cfg, batch=1, prompt_len=4, new_tokens=2, device="cpu",
                log=lambda m: None)
    assert res["tokens"].shape == (1, 2)


@pytest.mark.parametrize("flag", ["--intransit", "--mesh=1x1", "--pool=2",
                                  "--codec=int8-block", "--transport=scp_mem"])
def test_serve_cli_rejects_data_plane_flags(flag, capsys):
    from repro_torch.launch.serve import main
    with pytest.raises(SystemExit) as e:
        main(["--arch", "gemma2-27b", "--smoke", "--device", "cpu", flag])
    assert e.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err


def test_serve_cli_runs_on_the_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", "gemma2-27b", "--smoke", "--device", "cpu", "--batch", "2",
          "--prompt-len", "40", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "gemma2-27b-smoke" in out and "decode p50" in out


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
