"""The task scenes as MuJoCo 3 loads them, for the live baseline of
`bench_torch.py` and the port's direct check against `mujoco`
(`mj_envs_tpu/mjcf/oracle.py`'s `sanitize`, copied so that the port
reads nothing of the JAX package).

The scenes target MuJoCo 2.1 and name visual-only meshes (every mesh geom
is class D_Vizual, contype = conaffinity = 0, and every meshed body has
an explicit <inertial>), so the edits are: inline includes, drop mesh
geoms, mesh assets and file textures, strip the attributes MuJoCo 3 no
longer takes.  The physics is unchanged.  `mujoco` is imported only
inside `load`; nothing here runs on the port's path.
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET

from . import task_xml_path


def _inline_includes(path: str) -> ET.Element:
    root = ET.parse(path).getroot()
    base = os.path.dirname(os.path.abspath(path))

    def expand(elem: ET.Element):
        i = 0
        while i < len(elem):
            child = elem[i]
            if child.tag == "include":
                sub = _inline_includes(os.path.join(base, child.get("file")))
                elem.remove(child)
                for k, s in enumerate(list(sub)):
                    elem.insert(i + k, s)
            else:
                expand(child)
                i += 1

    expand(root)
    return root


def sanitize(path: str) -> str:
    """The scene at `path` as single-file MJCF text that MuJoCo 3 loads."""
    root = _inline_includes(path)
    if root.tag == "mujocoinclude":
        root.tag = "mujoco"

    def walk(elem: ET.Element):
        for child in list(elem):
            tag = child.tag
            if tag == "geom" and (child.get("mesh") is not None
                                  or child.get("type") == "mesh"
                                  or child.get("class") == "D_Vizual"):
                elem.remove(child)
                continue
            if tag == "mesh" or (tag == "texture"
                                 and child.get("file") is not None):
                elem.remove(child)
                continue
            if tag == "material":
                child.attrib.pop("texture", None)
            if tag == "option":
                child.attrib.pop("apirate", None)
            if tag == "size":      # legacy hints in MuJoCo 3
                for k in ("njmax", "nconmax", "nstack"):
                    child.attrib.pop(k, None)
            if tag == "compiler":
                child.attrib.pop("meshdir", None)
                child.attrib.pop("texturedir", None)
            walk(child)

    walk(root)
    return ET.tostring(root, encoding="unicode")


def load(task: str):
    """The sanitized vendored scene of `task` ("hammer", ...) as a
    `mujoco.MjModel`; raises ImportError without `mujoco`."""
    import mujoco
    return mujoco.MjModel.from_xml_string(sanitize(task_xml_path(task)))
