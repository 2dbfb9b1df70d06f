"""Rules of the PyTorch port that hold for every module of it.

* The port (`mj_envs_torch/`), `chip_smoke.py` and `bench_torch.py`
  import neither JAX nor the JAX package nor Triton, at module level or
  inside a function.
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
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "bench_torch.py")]
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
    assert len(files) > 20 and all(os.path.exists(f) for f in files)
    assert {os.path.join(ROOT, n) for n in ("chip_smoke.py",
                                              "bench_torch.py")} <= set(files)
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
        "mj_envs_torch.parallel.vector, mj_envs_torch.physics.pipeline, "
        "mj_envs_torch.algos.npg, mj_envs_torch.algos.sac, "
        "mj_envs_torch.algos.dapg, mj_envs_torch.utils.train, "
        "mj_envs_torch.run\n"
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
    """An unknown id raises, listing the four tasks; float64 (the JAX
    package's oracle-parity path) builds and steps; a dtype the port has
    no path for (bfloat16) raises."""
    from mj_envs_torch import envs
    from mj_envs_torch.parallel.vector import VectorEnv
    with pytest.raises(ValueError) as err:
        envs.make("cheetah-v0", device="cpu")
    for name in ("hammer-v0", "door-v0", "pen-v0", "relocate-v0"):
        assert name in str(err.value)
    env = envs.make("hammer-v0", device="cpu", dtype=torch.float64)
    venv = VectorEnv(env, 2)
    st = venv.step(venv.reset(seed=0), torch.zeros(2, env.nu,
                                                   dtype=torch.float64))
    assert st.data.qpos.dtype == torch.float64
    assert bool(torch.isfinite(st.obs).all())
    with pytest.raises(NotImplementedError):
        envs.make("hammer-v0", device="cpu", dtype=torch.bfloat16)


REFERENCES = ("linesearch_seq", "chol_solve_mat_block")


def _mentions(node):
    """The identifiers and string constants under `node` that name a
    reference kernel, as (what, text)."""
    for n in ast.walk(node):
        for what, text in (("name", getattr(n, "id", None)),
                           ("name", getattr(n, "attr", None)),
                           ("name", getattr(n, "name", None)),
                           ("string", n.value if isinstance(n, ast.Constant)
                            and isinstance(n.value, str) else None)):
            if isinstance(text, str) and any(r in text for r in REFERENCES):
                yield what, text


def test_reference_kernels_stay_off_the_port_path():
    """The reference kernels (the sequential linesearch and the block
    factor-and-solve, which the bit-for-bit checks hold the redesigned
    kernels against) are reached from no module of the port: only
    `physics/kernels.py` defines their wrappers and nothing else there
    calls them, `_build.py` only binds their C entries by name, and no
    other file of the port names them.  Read from the sources."""
    from mj_envs_torch.physics import kernels
    assert not set(REFERENCES) & set(kernels.KERNELS)
    wrappers = {f"{r}_cuda" for r in REFERENCES}
    pkg = os.path.join(ROOT, "mj_envs_torch")
    for path in _port_files():
        rel = os.path.relpath(path, pkg)
        if rel.startswith(".."):
            continue                       # chip_smoke.py runs the checks
        with open(path) as f:
            src = f.read()
        tree = ast.parse(src, filename=path)
        if rel == os.path.join("physics", "kernels.py"):
            defined = {n.name for n in tree.body
                       if isinstance(n, ast.FunctionDef)}
            assert wrappers <= defined
            doc = ast.get_docstring(tree, clean=False)
            for n in tree.body:
                if isinstance(n, ast.FunctionDef) and n.name in wrappers:
                    continue
                hits = [m for m in _mentions(n) if m[1] != doc]
                assert not hits, (rel, getattr(n, "name", None), hits)
        elif rel == os.path.join("physics", "_build.py"):
            assert {w for w, _ in _mentions(tree)} == {"string"}, rel
        else:
            assert not any(r in src for r in REFERENCES), rel
