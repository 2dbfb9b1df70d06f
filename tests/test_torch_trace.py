"""The port's tracer (`mj_envs_torch/trace.py`) on the CPU.

* Off (the default), a hammer step at B = 2 adds nothing to `counters`
  but what the kernel keys count, and its state equals the step with
  the tracer on, bit for bit.
* On, one env step holds every span of the step path with the counts
  one step makes (5 substeps, one narrowphase span per hammer pair-type
  group each), self time within the span's time, and the stage spans
  within the substep.
* The Newton counters against each env's own iterations (each env
  solved alone): the chunk's slots are B x its slowest env's.
* One registry: `kernels.launches is trace.counters`; the set-up spans
  (the kernel library built once); the renderer's span; the trainers'
  clock; synchronizing operations counted into the open spans, and the
  warnings' state given back when the tracer turns off.
* The benchmark's eight readers of the tracer, from a hand-built record
  and an empty one.
"""
import ctypes
import os
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.lib import spec as bench_spec
from mj_envs_torch import envs as tenvs
from mj_envs_torch import trace
from mj_envs_torch.physics import _build, kernels
from mj_envs_torch.physics import pipeline as P
from mj_envs_torch.physics import solver as S
from mj_envs_torch.physics.collision import driver as C
from mj_envs_torch.render import raster

B = 2
STAGES = ("physics.kinematics", "physics.smooth", "physics.collide",
          "physics.rows", "physics.newton", "physics.noslip",
          "physics.sensors", "physics.euler")
# hammer-v0's pair-type groups, in pair order (`driver._groups`)
HAMMER_GROUPS = ("plane_capsule", "plane_cylinder", "plane_box",
                 "capsule_capsule", "capsule_cylinder", "capsule_box",
                 "cylinder_cylinder", "cylinder_box", "box_box")


@pytest.fixture(scope="module")
def hammer():
    n = torch.get_num_threads()
    torch.set_num_threads(1)    # xdist workers share the CPU
    env = tenvs.make("hammer-v0", device="cpu")
    gen = env.generator(0)
    st = env.reset(B, gen)
    act = torch.linspace(-1.0, 1.0, B * env.nu).reshape(B, env.nu)
    st, _ = env._step_auto_reset_pair(st, act, gen)   # states in contact
    yield env, st
    torch.set_num_threads(n)


@pytest.fixture
def tracer():
    """The tracer on for one test, off again after it."""
    trace.enable()
    yield trace
    trace.enable(False)


def step_pair(env, st, on: bool):
    """One auto-reset step from `st` with the tracer on or off: (merged,
    raw, what the counters gained)."""
    trace.enable(on)
    try:
        before = dict(trace.counters)
        act = torch.full((B, env.nu), 0.3)
        merged, raw = env._step_auto_reset_pair(st, act, env.generator(7))
        return merged, raw, trace.since(before), set(before)
    finally:
        trace.enable(False)


def leaves(st):
    out = [getattr(st.data, f) for f in type(st.data).field_names()]
    out += [t for _, t in st.var.items()]
    return out + [getattr(st, f) for f in st.LEAVES]


def test_one_registry():
    assert kernels.launches is trace.counters
    assert all(k in trace.counters for k in kernels.KERNELS)
    assert not trace.enabled()
    trace.counters["span.t.reset.n"] = 3
    kernels.reset_launches()          # the whole registry, to 0
    assert not any(trace.counters.values())
    del trace.counters["span.t.reset.n"]


def test_off_counts_nothing_and_on_is_bit_for_bit(hammer):
    env, st = hammer
    off, off_raw, gained, keys = step_pair(env, st, False)
    assert set(trace.counters) == keys
    assert all(v == 0 for k, v in gained.items()
               if k not in kernels.KERNELS)
    on, on_raw, gained_on, _ = step_pair(env, st, True)
    assert gained_on["span.env.step.n"] == 1
    for a, b in zip(leaves(off) + leaves(off_raw),
                    leaves(on) + leaves(on_raw)):
        assert torch.equal(a, b)


def test_spans_of_one_env_step(hammer):
    env, st = hammer
    *_, gained, _ = step_pair(env, st, True)
    sp = {k: v for k, v in trace.spans(gained).items() if v["n"]}
    n = env.FRAME_SKIP
    want = {"env.step": 1, "env.physics": 1, "env.obs_reward": 1,
            "env.reset": 1, "env.merge": 1, "physics.substep": n,
            "collide.compact": n}
    want.update({s: n for s in STAGES})
    want.update({"collide." + g: n for g in HAMMER_GROUPS})
    assert {k: v["n"] for k, v in sp.items()} == want
    for v in sp.values():
        assert 0 <= v["self_ns"] <= v["ns"] and v["syncs"] == 0
    assert sum(sp[s]["ns"] for s in STAGES) <= sp["physics.substep"]["ns"]
    groups = sum(sp["collide." + g]["ns"] for g in HAMMER_GROUPS)
    assert groups + sp["collide.compact"]["ns"] \
        <= sp["physics.collide"]["ns"]
    assert sp["env.physics"]["ns"] <= sp["env.step"]["ns"]
    assert [C._SPANS[k][8:] for k, _ in C._groups(env.spec)] \
        == list(HAMMER_GROUPS)


def newton_counts(m, d, rows_of):
    """The Newton counters of one solve of the envs `rows_of`."""
    sel = lambda t: t[rows_of]
    out = P.forward_core(m, sel(d.qpos), sel(d.qvel), sel(d.ctrl),
                         sel(d.qacc_warmstart), sel(d.qfrc_applied))
    before = dict(trace.counters)
    S.newton_solve(out.M, out.qacc_smooth, out.rows,
                   sel(d.qacc_warmstart), iterations=m.spec.iterations)
    g = trace.since(before)
    return {k[7:]: g[k] for k in g if k.startswith("newton.")}


def test_newton_counters_against_each_env_alone(hammer, tracer):
    env, _ = hammer
    # Three fresh envs given seeded velocities: they converge apart.
    d = env.reset(3, env.generator(0)).data
    d = d.replace(qvel=torch.randn(d.qvel.shape,
                                   generator=torch.Generator().manual_seed(0)))
    whole = newton_counts(env.model, d, slice(0, 3))
    alone = [newton_counts(env.model, d, slice(b, b + 1)) for b in range(3)]
    assert whole["solves"] == 3
    assert whole["env_iters"] <= whole["slots"]
    own = [a["slots"] for a in alone]
    assert all(a["solves"] == 1 and a["env_iters"] == a["slots"]
               for a in alone)
    assert whole["env_iters"] == sum(own)
    # the loop runs the chunk until its slowest env has converged
    assert whole["slots"] == 3 * max(own)
    assert len(set(own)) > 1     # the envs converge apart


def test_setup_spans_and_library_builds(tracer, monkeypatch, tmp_path):
    before = dict(trace.counters)
    tenvs.make("door-v0", device="cpu")

    builds = []

    def compile_(out_dir):
        builds.append(out_dir)
        open(os.path.join(out_dir, "libmjkernels.so"), "w").close()
    monkeypatch.setattr(_build, "BUILD_ROOT", str(tmp_path))
    monkeypatch.setattr(_build, "_compile", compile_)
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_bind", lambda lib: lib)
    monkeypatch.setattr(ctypes, "CDLL", lambda path: path)
    assert _build.load().endswith("libmjkernels.so")
    _build.load()                 # loaded once, built once
    g = trace.since(before)
    assert g["span.setup.model_build.n"] == 1
    assert g["span.setup.model_build.ns"] > 0
    assert g["span.setup.kernel_library.n"] == 1
    assert len(builds) == 1


def test_render_chunk_span(hammer, tracer):
    env, st = hammer
    cam = raster.free_camera([0.0, -0.2, 0.2], 90.0, -30.0, 1.0,
                             height_px=8, device="cpu")
    before = dict(trace.counters)
    img = raster.render(env.model, st.data.geom_xpos, st.data.geom_xmat,
                        cam, 8, 8)
    assert img.shape == (B, 8, 8, 3)
    assert trace.since(before)["span.render.chunk.n"] == 1


def test_clock_laps_and_nesting(tracer):
    before = dict(trace.counters)
    clock = trace.Clock("cpu")
    with trace.span("t.outer"):
        with trace.span("t.inner"):
            pass
    ms = clock.lap()
    g = trace.since(before)
    assert ms * 1e6 >= g["span.t.outer.ns"] > 0
    assert 0 <= clock.lap() < ms + 1e3
    assert not any(k.startswith("span.") and not k.startswith("span.t.")
                   for k, v in g.items() if v)     # laps count nothing
    assert g["span.t.outer.self_ns"] == \
        g["span.t.outer.ns"] - g["span.t.inner.ns"]
    trace.enable(False)
    assert trace.span("t.off") is trace.span("t.other")
    trace.count("t.count")
    assert trace.since(before) == g


def test_syncs_counted_into_open_spans(tracer):
    before = dict(trace.counters)
    with trace.span("t.outer"):
        warnings.warn(trace.SYNC_WARNING + " (Triggered internally)")
        with trace.span("t.inner"):
            warnings.warn(trace.SYNC_WARNING)
    with pytest.warns(UserWarning, match="another warning"):
        warnings.warn("another warning")
    g = trace.since(before)
    assert g["span.t.outer.syncs"] == 2 and g["span.t.inner.syncs"] == 1


@pytest.mark.parametrize("order", ["inside", "around", "straddling"])
def test_warnings_given_back_when_off(order):
    """Turning the tracer off takes out its filter and its
    `showwarning`, and restores nothing that another warnings context
    set meanwhile: on and off inside such a context, around one, or on
    inside one and off after it has closed."""
    filters, shown = list(warnings.filters), warnings.showwarning
    if order == "inside":
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            inner = list(warnings.filters), warnings.showwarning
            trace.enable()
            trace.enable(False)
            assert (list(warnings.filters), warnings.showwarning) == inner
    elif order == "around":
        trace.enable()
        with warnings.catch_warnings():
            warnings.simplefilter("error")
        trace.enable(False)
    else:
        cw = warnings.catch_warnings()
        cw.__enter__()
        warnings.simplefilter("error")
        trace.enable()
        cw.__exit__(None, None, None)
        trace.enable(False)
    assert list(warnings.filters) == filters
    assert warnings.showwarning is shown


READERS = {
    # name: (launches of a window, value)
    "collide.host_share.rollout": (
        {"span.physics.collide.ns": 90, "span.physics.substep.ns": 100},
        0.9),
    "newton.env_iters.rollout": (
        {"newton.env_iters": 30, "newton.solves": 12}, 2.5),
    "newton.env_iters.train": (
        {"newton.env_iters": 30, "newton.solves": 12}, 2.5),
    "newton.idle_slot_share.rollout": (
        {"newton.env_iters": 30, "newton.slots": 40}, 0.25),
    "host.syncs_per_substep.rollout": (
        {"span.env.step.syncs": 300, "span.physics.substep.n": 5}, 60.0),
    "host.syncs_per_substep.b1": (
        {"span.env.step.syncs": 300, "span.physics.substep.n": 5}, 60.0),
}


@pytest.fixture
def reader():
    """A benchmark metric's reader (which turns the tracer on, as in a
    traced run), the tracer off again after the test."""
    yield lambda name: bench_spec.reader(name)
    trace.enable(False)


@pytest.mark.parametrize("name", sorted(READERS))
def test_window_reader(name, reader):
    launches, value = READERS[name]
    read = reader(name).read
    assert trace.enabled()
    assert read(SimpleNamespace(launches=dict(launches))) \
        == pytest.approx(value)
    assert read(SimpleNamespace(launches={})) is None


@pytest.mark.parametrize("name,span", [
    ("setup.kernel_library_s", "setup.kernel_library"),
    ("setup.model_build_s", "setup.model_build")])
def test_setup_reader(name, span, reader, monkeypatch):
    read = reader(name).read
    rec = SimpleNamespace(launches={})
    monkeypatch.delitem(trace.counters, f"span.{span}.ns", raising=False)
    assert read(rec) is None
    monkeypatch.setitem(trace.counters, f"span.{span}.ns", 2_500_000_000)
    assert read(rec) == pytest.approx(2.5)


def test_readers_listed_in_the_benchmark():
    names = {m["name"] for m in bench_spec.benchmark()["per_layer"]}
    assert set(READERS) | {"setup.kernel_library_s",
                           "setup.model_build_s"} <= names
    assert np.all([os.path.exists(os.path.join(bench_spec.BENCH, "metrics",
                                               n + ".py")) for n in names])
