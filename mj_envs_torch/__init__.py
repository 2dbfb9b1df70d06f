"""mj_envs_torch — the PyTorch/CUDA port of `mj_envs_tpu`: batched
MuJoCo-style physics and the Adroit tasks, batch-first tensors on an
NVIDIA Hopper card, with hand-written CUDA kernels for the solver's hot
loops (`physics/kernels.py`, sources in `csrc/`).

Physics matmuls run in full float32: TF32 (about three decimal digits)
would corrupt the dynamics the same way bf16 matmuls did in the JAX
package (1.6e-3 qpos divergence in 30 steps, `mj_envs_tpu/__init__.py`).
"""
import torch

torch.set_float32_matmul_precision("highest")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
