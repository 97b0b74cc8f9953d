"""The readers of the program's spans (``spans.py``) on hand-made traces:
each idle gap is split among the innermost program spans the host was in
while it lasted, the rest to ``outside``; no reading without spans, with
lost records or in the other mode."""

from __future__ import annotations

import pytest

from port_bench import harness, spans
from port_bench.trace import Trace

READERS = harness.readers()
SERVE = ("copy_idle_share.serve", "prep_idle_share.serve")
TRAIN = ("backward_idle_share.train",)


def _ctx(mode: str, device, cpu, launched: int = 0) -> harness.Context:
    return harness.Context(mode, {}, {}, {}, Trace(device, cpu, launched=launched))


def _read(name: str, ctx):
    return READERS[name].read(ctx)


# Device records (µs) with gaps (10, 20), (30, 50), (60, 65), (70, 96),
# (110, 120): 10 + 20 + 5 + 26 + 10 = 71 µs idle.
SERVE_DEVICE = [("Memcpy HtoD (Pageable -> Device)", 0, 10), ("gemm", 20, 30),
                ("attention", 50, 60), ("Memcpy DtoH (Device -> Pageable)", 65, 70),
                ("gemm", 96, 110), ("gemm", 120, 130)]
SERVE_CPU = [
    ("serve.segment", 0, 100),
    ("infer.volume", 5, 97),
    ("infer.drain", 8, 15),          # (10, 20): drain 5, then the volume's own 5
    ("infer.chunk", 25, 45),
    ("infer.copy_in", 28, 35),       # (30, 50): copy_in 5, chunk 10, volume 5
    ("cudaMemcpyAsync", 29, 31),     # a torch range: never a program span
    ("serve.finish", 58, 62),        # (60, 65): finish 2, volume 3
    # (70, 96): the volume's own 26
    ("serve.write", 115, 118),       # (110, 120): outside 5, write 3, outside 2
]


def test_gaps_split_among_the_innermost_spans():
    idle = spans.idle_by_span(Trace(SERVE_DEVICE, SERVE_CPU))
    assert idle == pytest.approx({"infer.drain": 5, "infer.copy_in": 5, "infer.chunk": 10,
                                  "serve.finish": 2, "infer.volume": 39, "serve.write": 3,
                                  spans.OUTSIDE: 7})
    assert sum(idle.values()) == pytest.approx(71)


def test_innermost_pieces_cover_the_spans():
    pieces = spans.innermost([("train.step", 0, 10), ("train.forward", 2, 4),
                              ("model.stage1", 2, 3), ("train.optimizer", 6, 8)])
    assert pieces == [(0, 2, "train.step"), (2, 3, "model.stage1"), (3, 4, "train.forward"),
                      (4, 6, "train.step"), (6, 8, "train.optimizer"), (8, 10, "train.step")]
    # between two spans the host is in none
    assert spans.innermost([("infer.drain", 0, 1), ("infer.pad", 3, 4)])[1] == (
        1, 3, spans.OUTSIDE)


def test_serve_readers():
    ctx = _ctx("serve_volumes", SERVE_DEVICE, SERVE_CPU)
    assert _read("copy_idle_share.serve", ctx) == pytest.approx(100 * 10 / 71)
    assert _read("prep_idle_share.serve", ctx) == pytest.approx(100 * 41 / 71)
    prepare = [("serve.segment", 0, 100), ("serve.prepare", 9, 21)]
    ctx = _ctx("serve_volumes", SERVE_DEVICE, prepare)
    # (10, 20) -> prepare; the rest, up to 100, the segment's own time
    assert _read("prep_idle_share.serve", ctx) == pytest.approx(100 * 61 / 71)
    assert _read("copy_idle_share.serve", ctx) == 0.0


def test_backward_reader():
    device = [("gemm", 0, 10), ("wgrad", 30, 40), ("stripe_attention_bwd", 45, 50),
              ("sgd", 70, 80)]
    cpu = [("train.step", 0, 90), ("train.forward", 0, 12), ("model.stage1", 1, 11),
           ("train.backward", 12, 48), ("CSWinBlockFnBackward", 39, 41),
           ("train.optimizer", 60, 85), ("Optimizer.step#SGD.step", 61, 84)]
    # (10, 30): stage1 1, forward 1, backward 18; (40, 45): backward 5;
    # (50, 70): the step's own 10, optimizer 10
    ctx = _ctx("train", device, cpu)
    assert _read("backward_idle_share.train", ctx) == pytest.approx(100 * 23 / 45)


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_no_reading_without_spans_or_records(name):
    mode = "train" if name.endswith(".train") else "serve_volumes"
    other = "serve_volumes" if mode == "train" else "train"
    assert _read(name, _ctx(mode, SERVE_DEVICE, SERVE_CPU)) is not None
    # the other mode's cell
    assert _read(name, _ctx(other, SERVE_DEVICE, SERVE_CPU)) is None
    # a program without spans (the parent of this reader's program)
    torch_only = [(n, s, e) for n, s, e in SERVE_CPU if not spans.PROGRAM_SPAN.fullmatch(n)]
    assert _read(name, _ctx(mode, SERVE_DEVICE, torch_only)) is None
    # the profiler lost a record of the program's kernels
    lost = [("void (anonymous namespace)::gemm_kernel<0, false, false, false>(Params)",
             0, 10)] + SERVE_DEVICE[1:]
    assert _read(name, _ctx(mode, lost, SERVE_CPU, launched=2)) is None
    assert _read(name, _ctx(mode, lost, SERVE_CPU, launched=1)) is not None
    # no gap
    assert _read(name, _ctx(mode, SERVE_DEVICE[:1], SERVE_CPU)) is None


def test_the_programs_span_names_are_program_spans():
    from cswin_unet_tpu_torch.utils.profiling import SPAN_NAMES

    assert all(spans.PROGRAM_SPAN.fullmatch(n) for n in SPAN_NAMES)
    assert not spans.PROGRAM_SPAN.fullmatch("Optimizer.step#SGD.step")
