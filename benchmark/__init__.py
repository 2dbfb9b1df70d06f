"""The benchmark of the PyTorch and CUDA port (`mj_envs_torch`): its
harness (`run.py`, `lib/`), configurations, traffic mixes, metric
readers and plain reference.  Nothing here imports JAX or the JAX
package; `reference/` imports nothing of the port."""
