"""Learners of the PyTorch port (`mj_envs_tpu/algos/`): the state-vector
actor-critic and PPO.  The pixel PPO, NPG/DAPG, SAC and PlaNet come in
later slices of the port."""
