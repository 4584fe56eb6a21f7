"""The port's spans (``followmyhold_tpu_torch/utils/profiling.py``) on the CPU:
parent and call ids, self time, the ring's bound, the ``profiled`` flag and
the ``record_function`` range inside a profiler session (its exported start
against the profiler's own event), the device clock's anchors on stand-in
CUDA events, stage 3's spans in one call of a tiny inpainter, and no
synchronisation on ``kontext_edit``'s path. No JAX."""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from followmyhold_tpu_torch.models import clip_text as TC
from followmyhold_tpu_torch.models import flux as TF
from followmyhold_tpu_torch.models import t5 as TT5
from followmyhold_tpu_torch.preprocess import inpaint as TI
from followmyhold_tpu_torch.tools import profile_inpaint as PI
from followmyhold_tpu_torch.utils import profiling as P

STAGE_SPANS = ("inpaint.call", "inpaint.tokenize", "inpaint.text", "flux.vae_encode",
               "flux.step", "flux.vae_decode", "inpaint.readback")


@pytest.fixture(autouse=True)
def _empty_ring():
    P.reset()
    yield
    P.reset()


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def test_parent_and_call_ids_per_thread():
    def call(tag):
        with P.span(f"{tag}.call"):
            with P.span(f"{tag}.a"):
                with P.span(f"{tag}.leaf"):
                    pass
            with P.span(f"{tag}.b"):
                pass

    call("main")
    worker = threading.Thread(target=call, args=("worker",))
    worker.start()
    worker.join(timeout=30)
    assert not worker.is_alive()
    with P.span("lone"):
        pass
    recs = _by_name(P.collect())
    for tag in ("main", "worker"):
        (c,), (a,), (leaf,), (b,) = (recs[f"{tag}.{n}"] for n in ("call", "a", "leaf", "b"))
        assert c.parent is None and c.call == c.id
        assert a.parent == c.id and b.parent == c.id and leaf.parent == a.id
        assert {a.call, b.call, leaf.call} == {c.id}
        assert len({c.id, a.id, leaf.id, b.id}) == 4
        assert c.host_start_ns <= a.host_start_ns <= leaf.host_end_ns <= b.host_start_ns
        assert b.host_end_ns <= c.host_end_ns
    assert recs["main.call"][0].thread != recs["worker.call"][0].thread
    assert recs["main.call"][0].call != recs["worker.call"][0].call
    lone = recs["lone"][0]
    assert lone.parent is None and lone.call == lone.id and lone.profiled is False
    # without CUDA the device interval is the host interval
    assert (lone.device_start_ns, lone.device_end_ns) == (lone.host_start_ns, lone.host_end_ns)


def test_self_time_is_the_interval_less_its_children():
    mk = P.SpanRecord
    ms = 1_000_000
    records = [
        mk("call", 1, None, 1, 0, 0, 100 * ms, 0, 100 * ms, False),
        mk("step", 2, 1, 1, 0, 5 * ms, 30 * ms, 10 * ms, 40 * ms, False),
        mk("step", 3, 1, 1, 0, 30 * ms, 60 * ms, 35 * ms, 70 * ms, False),   # overlaps 2
        mk("leaf", 4, 2, 1, 0, 6 * ms, 7 * ms, 20 * ms, 25 * ms, False),
        mk("graph", 5, 1, 1, 0, 80 * ms, 90 * ms, None, None, False),         # captured
    ]
    own = P.self_ms(records)
    assert own[1] == pytest.approx(100 - 60)             # the union [10, 70] of its steps
    assert own[2] == pytest.approx(30 - 5) and own[3] == pytest.approx(35)
    assert own[4] == pytest.approx(5) and 5 not in own
    assert P.covered_ns([(0, 10), (5, 20), (30, 40)], 8, 35) == 12 + 5


def test_the_ring_keeps_the_newest_records():
    for k in range(P.RING + 10):
        with P.span(f"s{k}"):
            pass
    recs = P.collect()
    assert len(recs) == P.RING
    assert recs[0].name == "s10" and recs[-1].name == f"s{P.RING + 9}"
    assert [r.id for r in recs] == sorted(r.id for r in recs)


def test_profiled_spans_open_a_record_function_range(tmp_path, monkeypatch):
    with P.span("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with P.span("warm"):          # a process's first range pays ~1.4 ms of set-up
            pass
    monkeypatch.setenv("FOHO_TPU_TRACE_DIR", str(tmp_path))
    with P.device_trace("spans"):
        with P.span("outer"):
            with P.span("inner"):
                torch.ones(64).sum()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with P.span("kineto"):
            torch.ones(64).sum()
    recs = _by_name(P.collect())
    assert recs["before"][0].profiled is False
    assert all(recs[n][0].profiled for n in ("outer", "inner", "kineto"))
    # the exported start lies on the profiler's clock: within 1 ms of its own event
    (event,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "kineto"]
    assert abs(recs["kineto"][0].host_start_ns - event.start_ns()) < 1_000_000
    trace = PI.read_chrome_trace(str(tmp_path / "spans.pt.trace.json"))
    for name in ("outer", "inner"):
        ((start, end),) = PI.range_offsets_ms(P.collect(), trace, name, side="host")
        assert abs(start) < 1.0 and abs(end) < 1.0
    assert not [r for r in trace.get("user_annotation", ()) if r[2] == "before"]


class _Card:
    """Stand-in CUDA events on a simulated device clock: an event's device
    time is the host time it was recorded at plus ``lag`` (how far the
    card's queue runs behind the host), read by a timer that runs ``rate``
    times the host's clock. ``hot`` makes any wait raise."""

    def __init__(self):
        self.lag_ns = 0
        self.rate = 1.0
        self.hot = False
        self.recorded = 0
        self.synchronized = 0
        card = self

        class Event:
            def __init__(self, enable_timing=False):
                assert enable_timing

            def record(self, stream=None):
                card.recorded += 1
                self.ns = (time.perf_counter_ns() + card.lag_ns) * card.rate

            def elapsed_time(self, other):
                assert not card.hot, "an event was read on the path"
                return (other.ns - self.ns) / 1e6

            def synchronize(self):
                assert not card.hot, "an event was waited for on the path"

        self.Event = Event

    def synchronize(self, device=None):
        assert not self.hot, "torch.cuda.synchronize on the path"
        self.synchronized += 1


@pytest.fixture
def card(monkeypatch):
    card = _Card()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(torch.cuda, "Event", card.Event)
    monkeypatch.setattr(torch.cuda, "synchronize", card.synchronize)
    return card


def test_device_times_come_from_the_calls_anchor(card, monkeypatch):
    ms = 1_000_000
    card.hot = True
    card.lag_ns = 5 * ms                     # the card 5 ms behind the host
    with P.span("call"):
        with P.span("step"):
            pass
        card.lag_ns = 0                      # the readback waited for the card
        with P.span("readback"):
            P.anchor()
    card.lag_ns = 3 * ms
    with P.span("lone"):                     # no anchor of its own
        pass
    P.anchor()                               # outside a span: nothing to tie
    assert card.recorded == 9 and card.synchronized == 0
    card.hot = False
    card.lag_ns = 7 * ms                     # collect()'s own anchor sees a 7 ms lag
    recs = _by_name(P.collect())
    assert card.synchronized == 1

    def lead(r):
        return (r.device_start_ns - r.host_start_ns) / ms

    assert lead(recs["step"][0]) == pytest.approx(5.0, abs=0.5)
    assert lead(recs["readback"][0]) == pytest.approx(0.0, abs=0.5)
    assert lead(recs["lone"][0]) == pytest.approx(3.0 - 7.0, abs=0.5)
    # resolved once: a second collect() neither waits nor moves a time
    assert [r.device_start_ns for r in P.collect()] == [
        r.device_start_ns for name in ("step", "readback", "call", "lone") for r in recs[name]]
    assert card.synchronized == 1

    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with P.span("captured"):
        pass
    assert card.recorded == 10               # collect()'s anchor; none while capturing
    (captured,) = [r for r in P.collect() if r.name == "captured"]
    assert captured.device_start_ns is None and captured.device_ms is None


def test_two_anchors_correct_the_event_clocks_rate(card):
    ms = 1_000_000
    card.rate = 1.01                         # the event timer 1 % fast
    steps = []
    for n_anchors in (2, 1):
        with P.span("call"):
            if n_anchors == 2:
                P.anchor()                   # a synchronous copy: the queue drained
            time.sleep(0.02)
            card.lag_ns = 5 * ms
            with P.span("step"):
                pass
            time.sleep(0.02)
            card.lag_ns = 0
            P.anchor()                       # the readback
        steps.append([r for r in P.collect() if r.name == "step"][-1])
    lead = [(r.device_start_ns - r.host_start_ns) / ms for r in steps]
    assert lead[0] == pytest.approx(5.0, abs=0.05)
    # one anchor reads the fast timer over the 15 ms or more back from it
    assert lead[1] < 5.0 - 0.1


def _tiny_inpainter():
    return TI.build_inpainter(
        seed=0, device="cpu", transformer_cfg=dataclasses.replace(TF.FLUX_TINY_TEST,
                                                                  pooled_dim=32),
        vae_cfg=TF.FLUX_VAE_TINY, clip_cfg=dataclasses.replace(TC.CLIP_TINY_TEST, vocab_size=1100),
        t5_cfg=TT5.T5_TINY_TEST)


@pytest.fixture
def no_assets(tmp_path, monkeypatch):
    """No converted weights and no vocabularies: the hashed token ids."""
    monkeypatch.setenv("FOHO_TPU_ASSETS", str(tmp_path / "assets"))
    monkeypatch.delenv("FOHO_ALLOW_HASH_TOKENIZER", raising=False)


def test_one_stage_call_records_the_stage_spans(no_assets, tmp_path):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        inpainter = _tiny_inpainter()
        crops, masks = tmp_path / "crops", tmp_path / "masks"
        crops.mkdir()
        masks.mkdir()
        img = np.random.default_rng(0).integers(0, 256, (32, 32, 3)).astype(np.uint8)
        Image.fromarray(img).save(crops / "000031_cropped_hoi_0.png")
        P.reset()
        record = {}
        with PI.timed_parts(record):
            TI.run(str(tmp_path / "out"), str(crops), mask_dir=str(masks), models=inpainter,
                   device="cpu")
    finally:
        torch.set_num_threads(threads)
    recs = P.collect()
    names = _by_name(recs)
    assert sorted(names) == sorted(STAGE_SPANS + ("inpaint.png",))
    assert {n: len(v) for n, v in names.items()} == dict(
        {n: 1 for n in STAGE_SPANS}, **{"flux.step": 28, "inpaint.png": 1})
    (call,) = names["inpaint.call"]
    for name in STAGE_SPANS[1:]:
        assert all(r.parent == call.id and r.call == call.id for r in names[name]), name
    assert names["inpaint.png"][0].parent is None
    steps = names["flux.step"]
    assert all(a.host_end_ns <= b.host_start_ns for a, b in zip(steps, steps[1:]))
    assert names["flux.vae_encode"][0].host_end_ns <= steps[0].host_start_ns
    # the per-part summary reads the same spans
    parts = PI.summarize_parts(record, 1)
    assert parts["n_steps"] == 28 and len(parts["steps_per_image"]) == 1
    assert parts["step_median"] > 0 and parts["png"] > 0
    assert parts["calls"]["text"] == [names["inpaint.text"][0].device_ms / 1e3]
    assert set(parts) == set(PI.PARTS) | {"steps_per_image", "step_median", "n_steps", "calls"}


def test_kontext_edit_does_not_synchronise(card, no_assets):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        inpainter = _tiny_inpainter()
        t5 = torch.randn(1, 5, inpainter.t5.cfg.d_model)
        pooled = torch.randn(1, 32)
        image = torch.rand(1, 32, 32, 3)
        card.hot = True
        with torch.no_grad():
            TF.kontext_edit(inpainter.transformer, inpainter.vae, t5, pooled, image,
                            torch.Generator().manual_seed(0), num_steps=3)
        card.hot = False
    finally:
        torch.set_num_threads(threads)
    names = _by_name(P.collect())
    assert {n: len(v) for n, v in names.items()} == {
        "flux.vae_encode": 1, "flux.step": 3, "flux.vae_decode": 1}
    # the spans' events and the ids' anchor; collect()'s is the one synchronise
    assert card.recorded == 2 * 5 + 1 + 1 and card.synchronized == 1


def test_idle_gaps_are_labelled_by_span(tmp_path):
    ms = 1_000_000
    trace = {
        "kernel": [(0, 10 * ms, "k"), (12 * ms, 20 * ms, "k"), (50 * ms, 60 * ms, "k")],
        "gpu_memcpy": [(19 * ms, 30 * ms, "copy")],
        "user_annotation": [(0, 100 * ms, "inpaint.call"), (35 * ms, 45 * ms, "flux.step"),
                            (35 * ms, 45 * ms, "aten::mm")],
        "gpu_user_annotation": [(0, 60 * ms, "inpaint.call"), (12 * ms, 30 * ms, "flux.step")],
    }
    gaps = PI.idle_gaps(trace, {"inpaint.call", "flux.step"}, n=5)
    assert gaps == [(20.0, "flux.step", "inpaint.call"), (2.0, "inpaint.call", "inpaint.call")]
