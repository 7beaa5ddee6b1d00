"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import no
JAX and nothing of the JAX package, and ``chip_smoke.py`` refuses to run
without a GPU or without the repository beside it."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"
BANNED = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)\b)",
                    re.M)


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        yield ".".join(p for p in rel.parts if p != "__init__")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_importing_every_module_loads_no_jax():
    mods = list(_modules())
    assert "repro_torch.kernels.conv2d_ws_pipe" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib')) or m == 'repro' "
            "or m.startswith('repro.'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], env=_env(), check=True,
                   timeout=120)


def test_no_source_imports_jax_or_the_reference():
    for path in sorted(PORT.rglob("*.py")) + [SMOKE]:
        hits = BANNED.findall(path.read_text())
        assert not hits, (path, hits)


def test_chip_smoke_fails_without_a_gpu_and_prints_no_result(tmp_path):
    for cwd, script in ((ROOT, SMOKE), (tmp_path, tmp_path / SMOKE.name)):
        if cwd == tmp_path:
            shutil.copy(SMOKE, script)
        env = _env()
        env.pop("PYTHONPATH")
        run = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert run.returncode != 0
        assert '"ok"' not in run.stdout
