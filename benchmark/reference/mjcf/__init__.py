"""MJCF front end of the reference: parser, model builder, asset paths,
frozen from the port's `mjcf/`.  The task XMLs are copies under
`benchmark/reference/assets/`, so the reference reads no file of the
port.
"""
import os

ASSETS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")


def task_xml_path(task: str) -> str:
    """Scene XML of a task, from the reference's own assets
    (`assets/DAPG_<task>.xml`)."""
    path = os.path.join(ASSETS, f"DAPG_{task}.xml")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no MJCF for task {task!r}: {path}")
    return path
