"""Rules of the PyTorch port that hold for every module of it.

* The port (`mj_envs_torch/`) and `chip_smoke.py` import neither JAX nor
  the JAX package nor Triton, at module level or inside a function.
* `import mj_envs_torch` works on a machine with no GPU and no nvcc.
* The entry points run on the card unless the caller asks for the CPU:
  without a GPU they raise instead of falling back.
"""
import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mj_envs_tpu", "triton")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "mj_envs_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_port_imports_no_jax_or_triton():
    files = _port_files()
    assert len(files) > 20 and os.path.exists(files[0])
    bad = [(os.path.relpath(p, ROOT), mod) for p in files
           for mod in _imported_modules(p)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_import_works_without_gpu_or_nvcc():
    """A fresh interpreter imports the whole package with CUDA hidden and
    no nvcc on PATH, and loads none of the forbidden modules."""
    code = (
        "import sys, torch\n"
        "import mj_envs_torch, mj_envs_torch.envs, "
        "mj_envs_torch.parallel.vector, mj_envs_torch.physics.pipeline\n"
        "assert not torch.cuda.is_available()\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "assert torch.get_float32_matmul_precision() == 'highest'\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "print('ok')\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PATH="/usr/bin:/bin",
               PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_make_defaults_to_the_card():
    from mj_envs_torch import envs
    from mj_envs_torch.parallel.vector import VectorEnv
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        envs.make("hammer-v0")
    env = envs.make("hammer-v0", device="cpu")
    assert env.model.qpos0.device.type == "cpu"
    assert VectorEnv(env, 4).env is env


def test_unported_task_and_dtype_raise():
    from mj_envs_torch import envs
    with pytest.raises(ValueError, match="door-v0"):
        envs.make("door-v0", device="cpu")
    with pytest.raises(NotImplementedError):
        envs.make("hammer-v0", device="cpu", dtype=torch.float64)
