"""Learners of the PyTorch port (`mj_envs_tpu/algos/`): the state-vector
and CNN actor-critics and PPO on states or pixels, NPG/DAPG with the
DAPG policy loader, SAC, and PlaNet with its sequence replay."""
