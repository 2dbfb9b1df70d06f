"""Utilities: quaternion maths of the task layer, and the trainer's
config, checkpoints, evaluation and training loop."""
