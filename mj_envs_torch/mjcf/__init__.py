"""MJCF front-end of the PyTorch port: parser, model builder, asset paths.

The four task XMLs are vendored under `mj_envs_torch/assets/` as data, so
the port reads nothing of the JAX package at run time.
"""
import os

ASSETS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")

_TASK_XML = {
    "hammer": "DAPG_hammer.xml",
    "door": "DAPG_door.xml",
    "pen": "DAPG_pen.xml",
    "relocate": "DAPG_relocate.xml",
}


def task_xml_path(task: str) -> str:
    """Scene XML of a task, from the port's vendored assets."""
    return os.path.join(ASSETS, _TASK_XML[task])
