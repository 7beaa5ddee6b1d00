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
    assert "repro_torch.launch.serve" in mods
    for m in ("repro_torch.core.training", "repro_torch.optim.adamw",
              "repro_torch.optim.schedule",
              "repro_torch.kernels.conv2d_ws_bwd",
              "repro_torch.core.calibration", "repro_torch.core.autotune",
              "repro_torch.core.calibration_sweep",
              "repro_torch.layers.moe",
              "repro_torch.configs.deepseek_moe_16b",
              "repro_torch.configs.qwen3_moe_30b_a3b",
              "repro_torch.configs.seamless_m4t_medium",
              "repro_torch.configs.internvl2_26b",
              "repro_torch.data.pipeline", "repro_torch.train.train_step",
              "repro_torch.train.trainer",
              "repro_torch.checkpoint.checkpoint",
              "repro_torch.launch.train",
              "repro_torch.distributed.sharding",
              "repro_torch.distributed.compression",
              "repro_torch.distributed.pipeline",
              "repro_torch.launch.mesh",
              "repro_torch.examples.conv_acceleration"):
        assert m in mods, m
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib')) or m == 'repro' "
            "or m.startswith('repro.'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], env=_env(), check=True,
                   timeout=120)


def _launcher_help(launcher):
    """``python -m repro_torch.launch.<launcher> --help`` with ``jax`` and
    ``repro`` made unimportable."""
    code = ("import runpy, sys\n"
            "for m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None\n"
            f"sys.argv = [{launcher!r}, '--help']\n"
            f"runpy.run_module('repro_torch.launch.{launcher}', "
            "run_name='__main__')\n")
    run = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert "--arch" in run.stdout and "--device" in run.stdout


def test_launcher_help_runs_with_jax_blocked():
    _launcher_help("serve")


def test_train_launcher_help_runs_with_jax_blocked():
    _launcher_help("train")


def test_dryrun_help_runs_with_jax_blocked():
    _launcher_help("dryrun")


def test_no_source_imports_jax_or_the_reference():
    for path in sorted(PORT.rglob("*.py")) + [
            SMOKE, ROOT / "tests" / "torch_dist_checks.py",
            ROOT / "tools" / "collectives_probe.py"]:
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
