"""MJCF front-end: parse the DAPG Adroit task XMLs into a flat model spec.

The PyTorch port's own copy of `mj_envs_tpu/mjcf/parser.py` (importing
that module would run the JAX package's `__init__`).  Host-side (numpy)
code, run once at model-build time.  Handles the MJCF
subset the Adroit suite uses (reference assets at
`mj_envs_vision/hand_manipulation_suite/assets/DAPG_*.xml`):

* ``<include>`` graphs (task XML -> DAPG_Adroit.xml + DAPG_assets.xml),
* nested ``<default>`` classes with childclass inheritance,
* bodies / joints (hinge+slide only; the suite has no free or ball joints,
  so ``nq == nv``) / geoms / sites / cameras / inertials,
* inertia-from-geom computation for bodies without ``<inertial>``
  (pen-v0's Object and target bodies, the table),
* fixed tendons (linear couplings over qpos), general (affine) actuators,
* explicit contact ``<pair>`` / ``<exclude>`` rows,
* sensors: actuatorfrc, touch, jointpos.

Mesh assets are visual-only in this suite (class ``D_Vizual`` geoms have
contype=conaffinity=0 and every meshed body carries an explicit
``<inertial>``), so mesh geoms are recorded for rendering but contribute
nothing to physics.
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

# MuJoCo enums (subset).
GEOM_PLANE = 0
GEOM_SPHERE = 2
GEOM_CAPSULE = 3
GEOM_ELLIPSOID = 4
GEOM_CYLINDER = 5
GEOM_BOX = 6
GEOM_MESH = 7

JNT_SLIDE = 2
JNT_HINGE = 3

GEOM_TYPES = {
    "plane": GEOM_PLANE,
    "sphere": GEOM_SPHERE,
    "capsule": GEOM_CAPSULE,
    "ellipsoid": GEOM_ELLIPSOID,
    "cylinder": GEOM_CYLINDER,
    "box": GEOM_BOX,
    "mesh": GEOM_MESH,
}
SITE_TYPES = GEOM_TYPES

JNT_TYPES = {"hinge": JNT_HINGE, "slide": JNT_SLIDE}


def _fl(s: str) -> List[float]:
    return [float(x) for x in s.split()]


def _arr(s: str, n: Optional[int] = None) -> np.ndarray:
    v = np.array(_fl(s), dtype=np.float64)
    if n is not None and v.size < n:
        v = np.concatenate([v, np.zeros(n - v.size)])
    return v


def _bool(s: str) -> bool:
    return s.lower() in ("true", "1")


def quat_mul_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ]
    )


def axis_quat_np(axis, angle) -> np.ndarray:
    axis = np.asarray(axis, dtype=np.float64)
    return np.concatenate([[np.cos(angle / 2)], np.sin(angle / 2) * axis])


def euler_to_quat_np(euler: np.ndarray) -> np.ndarray:
    """MuJoCo eulerseq='xyz' (intrinsic, moving axes): q = qx * qy * qz."""
    qx = axis_quat_np([1, 0, 0], euler[0])
    qy = axis_quat_np([0, 1, 0], euler[1])
    qz = axis_quat_np([0, 0, 1], euler[2])
    return quat_mul_np(quat_mul_np(qx, qy), qz)


def quat_to_mat_np(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def mat_to_quat_np(m: np.ndarray) -> np.ndarray:
    tr = np.trace(m)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array(
            [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
             (m[1, 0] - m[0, 1]) / s]
        )
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        q = np.array(
            [(m[2, 1] - m[1, 2]) / s, 0.25 * s, (m[0, 1] + m[1, 0]) / s,
             (m[0, 2] + m[2, 0]) / s]
        )
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        q = np.array(
            [(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s, 0.25 * s,
             (m[1, 2] + m[2, 1]) / s]
        )
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        q = np.array(
            [(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s,
             (m[1, 2] + m[2, 1]) / s, 0.25 * s]
        )
    if q[0] < 0:
        q = -q
    return q / np.linalg.norm(q)


def orientation_from_attrs(attrs: Dict[str, str]) -> np.ndarray:
    """Resolve quat/euler/axisangle attributes to a wxyz quaternion."""
    if "quat" in attrs:
        q = _arr(attrs["quat"], 4)
        return q / np.linalg.norm(q)
    if "euler" in attrs:
        return euler_to_quat_np(_arr(attrs["euler"], 3))
    if "axisangle" in attrs:
        aa = _arr(attrs["axisangle"], 4)
        ax = aa[:3] / np.linalg.norm(aa[:3])
        return axis_quat_np(ax, aa[3])
    return np.array([1.0, 0.0, 0.0, 0.0])


# ---------------------------------------------------------------------------
# Raw element records
# ---------------------------------------------------------------------------

@dataclass
class Body:
    name: str
    parent: int
    pos: np.ndarray
    quat: np.ndarray
    mocap: bool = False
    # Inertial (resolved after geom parsing if absent).
    ipos: Optional[np.ndarray] = None
    iquat: Optional[np.ndarray] = None
    mass: float = 0.0
    inertia: Optional[np.ndarray] = None  # diagonal, principal frame
    explicit_inertial: bool = False


@dataclass
class Joint:
    name: str
    body: int
    jtype: int
    pos: np.ndarray
    axis: np.ndarray
    limited: bool
    range: np.ndarray
    margin: float
    armature: float
    damping: float
    stiffness: float
    frictionloss: float
    ref: float
    springref: float
    solref_lim: np.ndarray
    solimp_lim: np.ndarray
    solref_fri: np.ndarray
    solimp_fri: np.ndarray


@dataclass
class Geom:
    name: str
    body: int
    gtype: int
    size: np.ndarray
    pos: np.ndarray
    quat: np.ndarray
    contype: int
    conaffinity: int
    condim: int
    priority: int
    friction: np.ndarray  # (slide, spin, roll)
    margin: float
    gap: float
    solref: np.ndarray
    solimp: np.ndarray
    solmix: float
    density: float
    rgba: np.ndarray
    group: int
    mesh: Optional[str] = None
    material: str = ""


@dataclass
class Site:
    name: str
    body: int
    stype: int
    size: np.ndarray
    pos: np.ndarray
    quat: np.ndarray
    rgba: np.ndarray
    group: int


@dataclass
class Camera:
    name: str
    body: int
    pos: np.ndarray
    quat: np.ndarray
    fovy: float


@dataclass
class Tendon:
    name: str
    limited: bool
    range: np.ndarray
    margin: float
    stiffness: float
    damping: float
    frictionloss: float
    solref_lim: np.ndarray
    solimp_lim: np.ndarray
    joints: List[Tuple[str, float]] = field(default_factory=list)


@dataclass
class Actuator:
    name: str
    joint: str
    ctrllimited: bool
    ctrlrange: np.ndarray
    forcelimited: bool
    forcerange: np.ndarray
    gaintype: str
    gainprm: np.ndarray  # (10,)
    biastype: str
    biasprm: np.ndarray  # (10,)


@dataclass
class Pair:
    geom1: str
    geom2: str
    condim: int
    friction: np.ndarray  # (5,)
    margin: float
    gap: float
    solref: np.ndarray
    solimp: np.ndarray


@dataclass
class Sensor:
    stype: str  # 'actuatorfrc' | 'touch' | 'jointpos'
    obj: str
    name: str


@dataclass
class Option:
    timestep: float = 0.002
    gravity: np.ndarray = field(
        default_factory=lambda: np.array([0.0, 0.0, -9.81]))
    iterations: int = 100
    noslip_iterations: int = 0
    tolerance: float = 1e-8
    noslip_tolerance: float = 1e-6
    impratio: float = 1.0
    integrator: str = "Euler"
    cone: str = "pyramidal"
    solver: str = "Newton"


@dataclass
class MjcfSpec:
    model_name: str
    option: Option
    bodies: List[Body]
    joints: List[Joint]
    geoms: List[Geom]
    sites: List[Site]
    cameras: List[Camera]
    tendons: List[Tendon]
    actuators: List[Actuator]
    pairs: List[Pair]
    excludes: List[Tuple[str, str]]
    sensors: List[Sensor]
    njmax: int = 500
    nconmax: int = 100


# ---------------------------------------------------------------------------
# Defaults machinery
# ---------------------------------------------------------------------------

class DefaultTree:
    """Nested default classes: class name -> {tag -> {attr -> str}}."""

    def __init__(self):
        self.classes: Dict[str, Dict[str, Dict[str, str]]] = {"main": {}}
        self.parent: Dict[str, Optional[str]] = {"main": None}

    def add(self, elem: ET.Element, parent_cls: str):
        cls = elem.get("class", "main" if parent_cls == "main" else None)
        if cls is None:
            raise ValueError("nested <default> requires a class name")
        if cls not in self.classes:
            self.classes[cls] = {}
            self.parent[cls] = parent_cls if cls != "main" else None
        for child in elem:
            if child.tag == "default":
                self.add(child, cls)
            else:
                self.classes[cls].setdefault(child.tag, {}).update(
                    child.attrib)

    def resolve(self, tag: str, cls: str, attrs: Dict[str, str]
                ) -> Dict[str, str]:
        """Merge class-chain defaults (root first) with element attrs."""
        chain = []
        c: Optional[str] = cls
        while c is not None:
            chain.append(c)
            c = self.parent.get(c)
        merged: Dict[str, str] = {}
        for c in reversed(chain):
            merged.update(self.classes.get(c, {}).get(tag, {}))
        merged.update(attrs)
        return merged


def _load_xml_with_includes(path: str) -> ET.Element:
    tree = ET.parse(path)
    root = tree.getroot()
    base = os.path.dirname(os.path.abspath(path))

    def expand(elem: ET.Element):
        i = 0
        while i < len(elem):
            child = elem[i]
            if child.tag == "include":
                inc_path = os.path.join(base, child.get("file"))
                inc_root = _load_xml_with_includes(inc_path)
                # Splice the include file's children in place.
                elem.remove(child)
                for j, sub in enumerate(list(inc_root)):
                    elem.insert(i + j, sub)
            else:
                expand(child)
                i += 1

    expand(root)
    return root


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------

class _Parser:
    def __init__(self):
        self.defaults = DefaultTree()
        self.spec: Optional[MjcfSpec] = None

    def parse(self, path: str) -> MjcfSpec:
        root = _load_xml_with_includes(path)
        option = Option()
        njmax, nconmax = 500, 100

        for opt in root.iter("option"):
            a = opt.attrib
            if "timestep" in a:
                option.timestep = float(a["timestep"])
            if "gravity" in a:
                option.gravity = _arr(a["gravity"], 3)
            if "iterations" in a:
                option.iterations = int(a["iterations"])
            if "noslip_iterations" in a:
                option.noslip_iterations = int(a["noslip_iterations"])
            if "tolerance" in a:
                option.tolerance = float(a["tolerance"])
            if "impratio" in a:
                option.impratio = float(a["impratio"])
            if "integrator" in a:
                option.integrator = a["integrator"]
            if "cone" in a:
                option.cone = a["cone"]
            if "solver" in a:
                option.solver = a["solver"]

        for sz in root.iter("size"):
            if "njmax" in sz.attrib:
                njmax = int(sz.attrib["njmax"])
            if "nconmax" in sz.attrib:
                nconmax = int(sz.attrib["nconmax"])

        for d in root.findall("default"):
            self.defaults.add(d, "main")

        self.spec = MjcfSpec(
            model_name=root.get("model", "mjcf"),
            option=option,
            bodies=[], joints=[], geoms=[], sites=[], cameras=[],
            tendons=[], actuators=[], pairs=[], excludes=[], sensors=[],
            njmax=njmax, nconmax=nconmax,
        )
        # World body.
        self.spec.bodies.append(
            Body(name="world", parent=-1, pos=np.zeros(3),
                 quat=np.array([1.0, 0, 0, 0]), explicit_inertial=True,
                 ipos=np.zeros(3), iquat=np.array([1.0, 0, 0, 0]),
                 mass=0.0, inertia=np.zeros(3))
        )

        for wb in root.findall("worldbody"):
            self._parse_body_children(wb, 0, "main")

        for tend in root.findall("tendon"):
            for f in tend.findall("fixed"):
                self._parse_fixed_tendon(f)
        for act in root.findall("actuator"):
            for g in act.findall("general"):
                self._parse_actuator(g)
        for con in root.findall("contact"):
            for p in con.findall("pair"):
                self._parse_pair(p)
            for e in con.findall("exclude"):
                self.spec.excludes.append((e.get("body1"), e.get("body2")))
        for sens in root.findall("sensor"):
            for s in sens:
                key = {"actuatorfrc": "actuator", "touch": "site",
                       "jointpos": "joint"}.get(s.tag)
                if key is None:
                    continue
                self.spec.sensors.append(
                    Sensor(stype=s.tag, obj=s.get(key),
                           name=s.get("name", f"{s.tag}_{s.get(key)}")))

        self._finalize_inertia()
        return self.spec

    # -- worldbody tree ----------------------------------------------------

    def _parse_body_children(self, elem: ET.Element, body_id: int,
                             childclass: str):
        sp = self.spec
        for child in elem:
            tag = child.tag
            if tag == "body":
                cls = child.get("childclass", childclass)
                b = Body(
                    name=child.get("name"),
                    parent=body_id,
                    pos=_arr(child.get("pos", "0 0 0"), 3),
                    quat=orientation_from_attrs(child.attrib),
                    mocap=_bool(child.get("mocap", "false")),
                )
                new_id = len(sp.bodies)
                sp.bodies.append(b)
                self._parse_body_children(child, new_id, cls)
            elif tag == "inertial":
                b = sp.bodies[body_id]
                a = child.attrib
                b.explicit_inertial = True
                b.ipos = _arr(a.get("pos", "0 0 0"), 3)
                b.iquat = orientation_from_attrs(a)
                b.mass = float(a.get("mass", "0"))
                if "diaginertia" in a:
                    b.inertia = _arr(a["diaginertia"], 3)
                elif "fullinertia" in a:
                    fi = _arr(a["fullinertia"], 6)
                    mat = np.array(
                        [[fi[0], fi[3], fi[4]],
                         [fi[3], fi[1], fi[5]],
                         [fi[4], fi[5], fi[2]]])
                    vals, vecs = np.linalg.eigh(mat)
                    order = np.argsort(vals)[::-1]
                    b.inertia = vals[order]
                    rot = vecs[:, order]
                    if np.linalg.det(rot) < 0:
                        rot[:, 2] *= -1
                    b.iquat = quat_mul_np(b.iquat, mat_to_quat_np(rot))
                else:
                    b.inertia = np.zeros(3)
            elif tag == "joint":
                self._parse_joint(child, body_id, childclass)
            elif tag == "geom":
                self._parse_geom(child, body_id, childclass)
            elif tag == "site":
                self._parse_site(child, body_id, childclass)
            elif tag == "camera":
                a = child.attrib
                sp.cameras.append(Camera(
                    name=a.get("name"),
                    body=body_id,
                    pos=_arr(a.get("pos", "0 0 0"), 3),
                    quat=orientation_from_attrs(a),
                    fovy=float(a.get("fovy", "45")),
                ))
            elif tag == "light":
                pass  # lights only matter for rendering; handled there

    def _parse_joint(self, elem: ET.Element, body_id: int, cls: str):
        a = self.defaults.resolve("joint", elem.get("class", cls),
                                  elem.attrib)
        jt = a.get("type", "hinge")
        if jt not in JNT_TYPES:
            raise NotImplementedError(
                f"joint type '{jt}' not supported (suite uses hinge/slide)")
        self.spec.joints.append(Joint(
            name=a.get("name"),
            body=body_id,
            jtype=JNT_TYPES[jt],
            pos=_arr(a.get("pos", "0 0 0"), 3),
            axis=(lambda ax: ax / np.linalg.norm(ax))(
                _arr(a.get("axis", "0 0 1"), 3)),
            limited=_bool(a.get("limited", "false")),
            range=_arr(a.get("range", "0 0"), 2),
            margin=float(a.get("margin", "0")),
            armature=float(a.get("armature", "0")),
            damping=float(a.get("damping", "0")),
            stiffness=float(a.get("stiffness", "0")),
            frictionloss=float(a.get("frictionloss", "0")),
            ref=float(a.get("ref", "0")),
            springref=float(a.get("springref", "0")),
            solref_lim=_arr(a.get("solreflimit", "0.02 1"), 2),
            solimp_lim=_arr(a.get("solimplimit", "0.9 0.95 0.001 0.5 2"), 5),
            solref_fri=_arr(a.get("solreffriction", "0.02 1"), 2),
            solimp_fri=_arr(a.get("solimpfriction",
                                  "0.9 0.95 0.001 0.5 2"), 5),
        ))

    def _parse_geom(self, elem: ET.Element, body_id: int, cls: str):
        a = self.defaults.resolve("geom", elem.get("class", cls),
                                  elem.attrib)
        gtype = GEOM_TYPES[a.get("type", "sphere")]
        self.spec.geoms.append(Geom(
            name=a.get("name"),
            body=body_id,
            gtype=gtype,
            size=_arr(a.get("size", "0 0 0"), 3),
            pos=_arr(a.get("pos", "0 0 0"), 3),
            quat=orientation_from_attrs(a),
            contype=int(a.get("contype", "1")),
            conaffinity=int(a.get("conaffinity", "1")),
            condim=int(a.get("condim", "3")),
            priority=int(a.get("priority", "0")),
            friction=_arr(a.get("friction", "1 0.005 0.0001"), 3),
            margin=float(a.get("margin", "0")),
            gap=float(a.get("gap", "0")),
            solref=_arr(a.get("solref", "0.02 1"), 2),
            solimp=_arr(a.get("solimp", "0.9 0.95 0.001 0.5 2"), 5),
            solmix=float(a.get("solmix", "1")),
            density=float(a.get("density", "1000")),
            rgba=_arr(a.get("rgba", "0.5 0.5 0.5 1"), 4),
            group=int(a.get("group", "0")),
            mesh=a.get("mesh"),
            material=a.get("material", ""),
        ))

    def _parse_site(self, elem: ET.Element, body_id: int, cls: str):
        a = self.defaults.resolve("site", elem.get("class", cls),
                                  elem.attrib)
        self.spec.sites.append(Site(
            name=a.get("name"),
            body=body_id,
            stype=SITE_TYPES[a.get("type", "sphere")],
            size=_arr(a.get("size", "0.005 0.005 0.005"), 3),
            pos=_arr(a.get("pos", "0 0 0"), 3),
            quat=orientation_from_attrs(a),
            rgba=_arr(a.get("rgba", "0.5 0.5 0.5 1"), 4),
            group=int(a.get("group", "0")),
        ))

    # -- non-tree sections --------------------------------------------------

    def _parse_fixed_tendon(self, elem: ET.Element):
        a = self.defaults.resolve("tendon", elem.get("class", "main"),
                                  elem.attrib)
        t = Tendon(
            name=a.get("name"),
            limited=_bool(a.get("limited", "false")),
            range=_arr(a.get("range", "0 0"), 2),
            margin=float(a.get("margin", "0")),
            stiffness=float(a.get("stiffness", "0")),
            damping=float(a.get("damping", "0")),
            frictionloss=float(a.get("frictionloss", "0")),
            solref_lim=_arr(a.get("solreflimit", "0.02 1"), 2),
            solimp_lim=_arr(a.get("solimplimit", "0.9 0.95 0.001 0.5 2"), 5),
        )
        for j in elem.findall("joint"):
            t.joints.append((j.get("joint"), float(j.get("coef"))))
        self.spec.tendons.append(t)

    def _parse_actuator(self, elem: ET.Element):
        a = self.defaults.resolve("general", elem.get("class", "main"),
                                  elem.attrib)
        self.spec.actuators.append(Actuator(
            name=a.get("name"),
            joint=a.get("joint"),
            ctrllimited=_bool(a.get("ctrllimited", "false")),
            ctrlrange=_arr(a.get("ctrlrange", "0 0"), 2),
            forcelimited=_bool(a.get("forcelimited", "false")),
            forcerange=_arr(a.get("forcerange", "0 0"), 2),
            gaintype=a.get("gaintype", "fixed"),
            gainprm=_arr(a.get("gainprm", "1 0 0"), 10),
            biastype=a.get("biastype", "none"),
            biasprm=_arr(a.get("biasprm", "0 0 0"), 10),
        ))

    def _parse_pair(self, elem: ET.Element):
        a = self.defaults.resolve("pair", elem.get("class", "main"),
                                  elem.attrib)
        self.spec.pairs.append(Pair(
            geom1=a.get("geom1"),
            geom2=a.get("geom2"),
            condim=int(a.get("condim", "3")),
            friction=_arr(a.get("friction", "1 1 0.005 0.0001 0.0001"), 5),
            margin=float(a.get("margin", "0")),
            gap=float(a.get("gap", "0")),
            solref=_arr(a.get("solref", "0.02 1"), 2),
            solimp=_arr(a.get("solimp", "0.9 0.95 0.001 0.5 2"), 5),
        ))

    # -- inertia from geoms --------------------------------------------------

    def _finalize_inertia(self):
        for bid, b in enumerate(self.spec.bodies):
            if b.explicit_inertial:
                continue
            geoms = [g for g in self.spec.geoms
                     if g.body == bid and g.gtype != GEOM_MESH]
            if not geoms:
                b.ipos = np.zeros(3)
                b.iquat = np.array([1.0, 0, 0, 0])
                b.mass = 0.0
                b.inertia = np.zeros(3)
                continue
            masses, coms, inertias = [], [], []
            for g in geoms:
                m, I_local = _geom_mass_inertia(g)
                R = quat_to_mat_np(g.quat)
                I_world = R @ I_local @ R.T
                masses.append(m)
                coms.append(g.pos)
                inertias.append(I_world)
            masses = np.array(masses)
            coms = np.array(coms)
            total = masses.sum()
            com = (masses[:, None] * coms).sum(axis=0) / total
            I_tot = np.zeros((3, 3))
            for m, c, I in zip(masses, coms, inertias):
                d = c - com
                I_tot += I + m * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
            vals, vecs = np.linalg.eigh(I_tot)
            order = np.argsort(vals)[::-1]
            vals = vals[order]
            rot = vecs[:, order]
            if np.linalg.det(rot) < 0:
                rot[:, 2] *= -1
            b.ipos = com
            b.iquat = mat_to_quat_np(rot)
            b.mass = float(total)
            b.inertia = vals


def _geom_mass_inertia(g: Geom) -> Tuple[float, np.ndarray]:
    """Mass and rotational inertia about the geom com, geom frame."""
    rho = g.density
    s = g.size
    if g.gtype == GEOM_SPHERE:
        r = s[0]
        m = rho * 4.0 / 3.0 * np.pi * r ** 3
        i = 0.4 * m * r * r
        return m, np.diag([i, i, i])
    if g.gtype == GEOM_CYLINDER:
        r, h = s[0], s[1]  # h = half-length
        m = rho * np.pi * r * r * (2 * h)
        ixx = m * (3 * r * r + (2 * h) ** 2) / 12.0
        izz = 0.5 * m * r * r
        return m, np.diag([ixx, ixx, izz])
    if g.gtype == GEOM_BOX:
        a, bb, c = s
        m = rho * 8.0 * a * bb * c
        return m, np.diag([
            m * (bb * bb + c * c) / 3.0,
            m * (a * a + c * c) / 3.0,
            m * (a * a + bb * bb) / 3.0,
        ])
    if g.gtype == GEOM_CAPSULE:
        r, h = s[0], s[1]
        m_cyl = rho * np.pi * r * r * (2 * h)
        m_sph = rho * 4.0 / 3.0 * np.pi * r ** 3
        # Cylinder part.
        ixx = m_cyl * (3 * r * r + (2 * h) ** 2) / 12.0
        izz_c = 0.5 * m_cyl * r * r
        # Two hemispheres at +-h (full sphere, shifted).
        i_sph = 0.4 * m_sph * r * r
        # Hemisphere com offset from flat face: 3r/8; combine both caps.
        # Use MuJoCo's formula: sphere inertia + parallel-axis with
        # offset distribution of the two hemispheres.
        izz_s = i_sph
        ixx_s = i_sph + m_sph * (0.5 * r * h * 3.0 / 4.0 * 2.0 + h * h)
        # MuJoCo: ixx_s = m_sph*(0.4 r^2 + h^2 + 0.75 r h)
        ixx_s = m_sph * (0.4 * r * r + h * h + 0.75 * r * h)
        return m_cyl + m_sph, np.diag(
            [ixx + ixx_s, ixx + ixx_s, izz_c + izz_s])
    if g.gtype == GEOM_ELLIPSOID:
        a, bb, c = s
        m = rho * 4.0 / 3.0 * np.pi * a * bb * c
        return m, np.diag([
            m * (bb * bb + c * c) / 5.0,
            m * (a * a + c * c) / 5.0,
            m * (a * a + bb * bb) / 5.0,
        ])
    # Planes / meshes contribute nothing here.
    return 0.0, np.zeros((3, 3))


def parse_mjcf(path: str) -> MjcfSpec:
    return _Parser().parse(path)
