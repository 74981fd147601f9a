"""The port's own spans and counters on a torch.profiler trace: the stages
of GaussianTrainer.train_iteration and GaussianMapper.render_from_pose
named, nested and identified as the benchmark's readers
(port_bench/metrics) expect, nothing recorded and no range opened with no
session, the graph cache's counters on a card, and the readers' arithmetic
on hand-made records and gaps and on tiny traced cells.

This file imports no JAX, so its `card` case runs on a machine with a card
and without JAX:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_tracing.py -m card
"""
import contextlib
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from photo_slam_tpu_torch.config import Config
from photo_slam_tpu_torch.mapper.mapper import GaussianMapper, SensorType
from photo_slam_tpu_torch.models.camera import PINHOLE, Camera
from photo_slam_tpu_torch.models.keyframe import Keyframe
from photo_slam_tpu_torch.utils import profiling
from photo_slam_tpu_torch.utils.profiling import Profiler

REPO = Path(__file__).resolve().parents[1]
W, H = 64, 48
POSE = (np.array([1.0, 0.0, 0.0, 0.0]), np.array([0.0, 0.0, 0.0]))
# The per-layer metrics that read the program's spans and counters, and
# the cell each is read in.
NEW_METRICS = {
    "train_host_ms": "train", "train_enqueue_ms": "train",
    "train_fetch_ms": "train", "graph_captures.train": "train",
    "device_idle_program.train": "train", "graph_captures.view": "view",
    "view_host_ms_p95": "view", "view_camera_ms": "view",
    "view_copy_mb": "view", "device_idle_program.view": "view"}
TRAIN_STAGES = ["mapper.sample", "mapper.gt", "mapper.enqueue",
                "mapper.events"]
REQUEST_STAGES = ["viewer.camera", "viewer.lock_wait", "viewer.render",
                  "viewer.d2h"]
RENDER_STAGES = ["viewer.activate", "viewer.enqueue", "viewer.wait"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: graphs are captured and replayed "
                    "only on a card")
    return torch.device("cuda", 0)


@contextlib.contextmanager
def session():
    """A CPU torch.profiler session over an emptied traced record."""
    profiling.clear_traced()
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        yield prof


def cpu_mapper(dist=None) -> GaussianMapper:
    """A mapper on the CPU with 50 Gaussians and two keyframes."""
    cfg = Config()
    cfg.renderer.initial_capacity = 256
    mapper = GaussianMapper(cfg, SensorType.RGBD, device="cpu")
    extra = {} if dist is None else {"dist_coeffs": np.asarray(
        dist, np.float32)}
    cam = Camera(camera_id=0, model_id=PINHOLE, width=W, height=H, fx=60.0,
                 fy=60.0, cx=32, cy=24, **extra)
    mapper.add_camera(cam)
    rng = np.random.RandomState(0)
    pts = (rng.randn(50, 3) * 0.5 + [0, 0, 5]).astype(np.float32)
    mapper.trainer.initialize_map(pts, rng.rand(50, 3).astype(np.float32))
    mapper.initial_mapped = True
    for fid in (0, 1):
        kf = Keyframe(fid=fid, camera=cam)
        kf.set_pose(POSE[0], np.array([0.1 * fid, 0, 0]), device="cpu")
        kf.set_image(np.full((3, H, W), 0.5, np.float32))
        kf.remaining_times_of_use = 10**9
        mapper.scene.add_keyframe(kf)
    return mapper


def children(records: list, parent: dict) -> list:
    """Names of `parent`'s child spans, in the order they started."""
    kids = [r for r in records if r["parent"] == parent["id"]]
    return [r["name"] for r in sorted(kids, key=lambda r: r["start_ns"])]


def descendants(records: list, root: dict) -> list:
    out, todo = [], [root["id"]]
    while todo:
        sid = todo.pop()
        kids = [r for r in records if r["parent"] == sid]
        out += kids
        todo += [r["id"] for r in kids]
    return out


def test_train_iteration_stages():
    """Each iteration is a mapper.iteration span identified by its
    iteration, holding the sample, GT, enqueue (the lock wait inside),
    events (densify and the reset inside where due) and fetch stages; the
    counters count the GT uploads, their bytes and the host reads."""
    mapper = cpu_mapper()
    tr = mapper.trainer
    o = tr.cfg.opt
    o.densify_from_iter, o.densification_interval = 0, 2
    o.opacity_reset_interval, o.densify_until_iter = 2, 10**6
    with session() as prof:
        tr.train_iteration(fetch_metrics=True)
        tr.train_iteration(fetch_metrics=False)
    rec = profiling.traced(records=True)
    records = rec["records"]
    roots = [r for r in records if r["name"] == "mapper.iteration"]
    assert [r["ident"] for r in roots] == [1, 2]
    assert all(r["parent"] == 0 for r in roots)
    for it, root in enumerate(roots, 1):
        assert children(records, root) == TRAIN_STAGES + (
            ["mapper.fetch"] if it == 1 else [])
        assert {r["ident"] for r in descendants(records, root)} == {it}
        stage = {r["name"]: r for r in records if r["parent"] == root["id"]}
        assert children(records, stage["mapper.enqueue"]) == [
            "mapper.lock_wait"]
        assert children(records, stage["mapper.events"]) == (
            [] if it == 1 else ["mapper.densify", "mapper.opacity_reset"])
    uploads = rec["counters"]["mapper.gt_uploads"]
    assert 1 <= uploads <= 2
    assert rec["counters"] == {
        "mapper.gt_uploads": uploads,
        "mapper.gt_upload_bytes": uploads * 3 * H * W * 4,
        "mapper.host_syncs": 3}   # loss, psnr, the live count
    assert dict(tr.profiler.counters) == rec["counters"]
    assert tr.profiler.summary()["mapper.iteration"]["count"] == 2
    idents = [e.concrete_inputs for e in prof.events()
              if e.name in ("mapper.iteration", "mapper.gt")]
    assert sorted(idents) == [[1], [1], [2], [2]]


def test_batched_iteration_stages():
    mapper = cpu_mapper()
    tr = mapper.trainer
    with session():
        tr.train_iteration_batched(list(mapper.scene.keyframes.values()))
    records = profiling.traced(records=True)["records"]
    (root,) = [r for r in records if r["name"] == "mapper.iteration"]
    assert root["ident"] == 1
    assert children(records, root) == TRAIN_STAGES + ["mapper.fetch"]


@pytest.mark.parametrize("dist", [None, [0.1, 0.01, 0.0, 0.0, 0.0]],
                         ids=["pinhole", "distorted"])
def test_render_from_pose_stages(dist):
    """Each call is a viewer.request span identified by the mapper's frame
    count, holding the camera, lock wait, render (activate, enqueue,
    wait), copy and, for a distorted camera, mask stages; with a profiler
    given they are also its spans, without one they reach only the
    trace."""
    mapper = cpu_mapper(dist)
    prof = Profiler()
    before = profiling.DISABLED.summary()
    with session():
        first = mapper.render_from_pose(*POSE, 40, 30)
        second = mapper.render_from_pose(*POSE, 40, 30, profiler=prof)
    np.testing.assert_array_equal(first, second)
    records = profiling.traced(records=True)["records"]
    roots = [r for r in records if r["name"] == "viewer.request"]
    assert [r["ident"] for r in roots] == [1, 2]
    mask = [] if dist is None else ["viewer.mask"]
    for root in roots:
        assert children(records, root) == REQUEST_STAGES + mask
        (render,) = [r for r in records if r["parent"] == root["id"]
                     and r["name"] == "viewer.render"]
        assert children(records, render) == RENDER_STAGES
        assert {r["ident"] for r in descendants(records, root)} == {
            root["ident"]}
    names = {"viewer.request", *REQUEST_STAGES, *RENDER_STAGES, *mask}
    assert set(prof.summary()) == names
    assert all(s["count"] == 1 for s in prof.summary().values())
    assert profiling.DISABLED.summary() == before == {}


def test_no_session_records_nothing_and_opens_no_range(monkeypatch):
    """With no torch.profiler session a stage span opens no
    record_function range and adds nothing to the traced record; with one
    it does."""
    opened = []
    enter = torch.autograd._record_function_with_args_enter

    def counting(*args):
        opened.append(args[0])
        return enter(*args)

    monkeypatch.setattr(torch.autograd, "_record_function_with_args_enter",
                        counting)
    mapper = cpu_mapper()
    profiling.clear_traced()
    mapper.trainer.train_iteration()
    mapper.render_from_pose(*POSE, 40, 30)
    assert opened == []
    assert profiling.traced() == {"spans": {}, "counters": {}}
    with session():
        mapper.render_from_pose(*POSE, 40, 30)
    assert opened[0] == "viewer.request"
    assert profiling.traced()["spans"]["viewer.request"]["count"] == 1


@pytest.mark.card
def test_graph_cache_counts_captures_replays_and_bytes(card):
    """While a session records, a capture is a graphs.capture span and
    counts graphs.captures; each replay counts graphs.replays, the bytes
    copied into the input buffers and those cloned out; a caller that
    passes the buffer copies nothing. With no session nothing is
    counted."""
    from photo_slam_tpu_torch.utils.graphs import GraphCache

    cache = GraphCache()
    x = torch.arange(1000, dtype=torch.float32, device=card)

    def fn(a):
        return a * 2.0, a.sum()

    with session():
        out = cache.run("k", fn, (x,), clone=True)
        buf = cache.input_buffer(0, x.shape, x.dtype, card)
        buf.copy_(x)
        cache.run("k", fn, (buf,), replays=3)
        torch.cuda.synchronize(card)
    rec = profiling.traced()
    assert rec["counters"] == {"graphs.captures": 1, "graphs.replays": 4,
                               "graphs.copy_bytes": 4000,
                               "graphs.clone_bytes": 4000 + 4}
    assert rec["spans"]["graphs.capture"]["count"] == 1
    assert (cache.captures, cache.replays) == (1, 4)
    assert torch.equal(out[0], x * 2.0)
    profiling.clear_traced()
    cache.run("k", fn, (x,), clone=True)
    torch.cuda.synchronize(card)
    assert profiling.traced() == {"spans": {}, "counters": {}}
    assert (cache.captures, cache.replays) == (1, 5)


# ---------------------------------------------------------------------------
# The benchmark's readers of the program's spans and counters.
# ---------------------------------------------------------------------------

def reader(name: str):
    from port_bench import byname

    return byname.module(REPO, "metrics", name).read


def span(count, mean, p95=0.0):
    return {"count": count, "total_ms": count * mean, "mean_ms": mean,
            "p95_ms": p95, "max_ms": p95, "self_ms": 0.0}


RECORD = {
    "spans": {"mapper.iteration": span(180, 2.5, 4.0),
              "mapper.enqueue": span(180, 1.25),
              "mapper.fetch": span(18, 9.5),
              "viewer.request": span(300, 5.0, 7.75),
              "viewer.camera": span(300, 0.375)},
    "counters": {"graphs.captures": 2, "graphs.replays": 300,
                 "graphs.copy_bytes": 300 * 70_800_000,
                 "graphs.clone_bytes": 300 * 16_000_000}}
GAPS = {"mapper.enqueue": 0.018, "mapper.fetch": 0.0045,
        "graphs.capture": 0.0015, "viewer.camera": 0.06,
        "viewer.activate": 0.03, "cudaGraphLaunch": 0.2,
        "port_bench.iteration": 0.1, "no host activity": 0.05}
EXPECTED = {
    "train_host_ms": 2.5, "train_enqueue_ms": 1.25, "train_fetch_ms": 9.5,
    "graph_captures.train": 2, "graph_captures.view": 2,
    "view_host_ms_p95": 7.75, "view_camera_ms": 0.375,
    "view_copy_mb": 86.8,
    # (0.018 + 0.0045 + 0.0015) s over 12 iterations, in ms.
    "device_idle_program.train": 2.0,
    # (0.06 + 0.03 + 0.0015) s over 12 frames, in ms.
    "device_idle_program.view": 7.625}


def layer_with_gaps(ops=10):
    from port_bench.trace import DeviceTrace

    return {"trace": DeviceTrace(window_s=2.0, busy_s=1.0, ops=ops,
                                 gaps=dict(GAPS)),
            "count": 12, "window_s": 2.0}


@pytest.mark.parametrize("name", sorted(NEW_METRICS))
def test_reader_arithmetic(monkeypatch, name):
    monkeypatch.setattr(profiling, "traced", lambda records=False: RECORD)
    assert reader(name)(layer_with_gaps()) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(NEW_METRICS))
def test_readers_give_none_without_a_record(monkeypatch, name):
    """An empty record, or an older program without one, gives None and
    raises nothing."""
    monkeypatch.setattr(profiling, "traced",
                        lambda records=False: {"spans": {}, "counters": {}})
    assert reader(name)(layer_with_gaps()) is None
    monkeypatch.delattr(profiling, "traced")
    assert reader(name)(layer_with_gaps()) is None


def test_readers_on_a_partial_record(monkeypatch):
    """A counter the record lacks reads 0; a span it lacks, or a trace
    without a device operation, reads None."""
    part = {"spans": {"viewer.request": span(4, 5.0, 6.0)},
            "counters": {"graphs.replays": 4}}
    monkeypatch.setattr(profiling, "traced", lambda records=False: part)
    layer = layer_with_gaps(ops=0)
    assert reader("graph_captures.train")(layer) == 0
    assert reader("view_copy_mb")(layer) == 0.0
    assert reader("train_host_ms")(layer) is None
    assert reader("device_idle_program.view")(layer) is None
    assert reader("device_idle_program.view")(layer_with_gaps()) == \
        pytest.approx(7.625)


def test_new_metrics_in_the_manifest():
    """Each reader is a per-layer entry of BENCHMARK.json read in its
    cell."""
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in manifest["per_layer"]}
    for name, kind in NEW_METRICS.items():
        assert entries[name]["workloads"] == [f"replica_rgbd.{kind}"]
        assert entries[name]["moves"] == (
            "train_it_s" if kind == "train" else "view_fps")


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """The benchmark's tiny CPU checkout (port_bench/tests/tinyroot.py)
    with the new readers as per-layer metrics of its cells."""
    from port_bench.tests import tinyroot

    root = tinyroot.make(tmp_path_factory.mktemp("bench"))
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {"train": "tinyroom.tinytrain", "view": "tinyroom.tinyview"}
    repo = {m["name"]: m for m in json.loads(
        (REPO / "BENCHMARK.json").read_text())["per_layer"]}
    for name, kind in NEW_METRICS.items():
        manifest["per_layer"].append(dict(repo[name], workloads=[cells[kind]]))
        shutil.copy(REPO / "port_bench/metrics" / f"{name}.py",
                    root / "port_bench/metrics")
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root


@pytest.mark.parametrize("kind, cell, read", [
    ("train", "tinyroom.tinytrain",
     {"train_host_ms", "train_enqueue_ms", "graph_captures.train"}),
    ("view", "tinyroom.tinyview",
     {"graph_captures.view", "view_host_ms_p95", "view_camera_ms",
      "view_copy_mb"})])
def test_tiny_traced_cell_reports_the_new_metrics(tiny_root, kind, cell,
                                                   read):
    """A traced run of a tiny cell on the CPU reports each new metric the
    CPU gives (no device idle there, no graph: 0 captures, 0 MB) beside
    the cell's own."""
    from port_bench import run

    profiling.clear_traced()
    r = run.run_cell(tiny_root, cell, 2 ** 31 + 977, 0.5, True, "cpu")
    assert r["correct"], r["checks"]
    got = {m for m in r["metrics"] if m in NEW_METRICS}
    assert read <= got
    assert got <= read | {"train_fetch_ms"}
    assert ("tiny_count" in r["metrics"]) == (kind == "train")
    captures = r["metrics"][f"graph_captures.{kind}"]["value"]
    assert captures == 0
    if kind == "train":
        assert 0 < r["metrics"]["train_enqueue_ms"]["value"] <= \
            r["metrics"]["train_host_ms"]["value"]
    else:
        assert r["metrics"]["view_copy_mb"]["value"] == 0.0
