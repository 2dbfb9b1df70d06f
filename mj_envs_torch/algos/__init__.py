"""Learners of the PyTorch port (`mj_envs_tpu/algos/`): the state-vector
actor-critic and PPO, NPG/DAPG with the DAPG policy loader, and SAC.
The pixel PPO and PlaNet come in later slices of the port."""
