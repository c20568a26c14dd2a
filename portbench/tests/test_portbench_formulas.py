"""The operation and byte counts behind MFU and the rooflines, against
counts made by hand, and the readers that turn them into metrics."""
import types

import pytest

from portbench import flops, harness, peaks

QWEN = harness.load_json(harness.BENCH_DIR / "configs" / "qwen3-1.7b.json")
MODEL = harness.load_file(harness.BENCH_DIR / "configs" / "qwen3-1.7b.py")


def test_layer_weights_of_qwen3_1p7b():
    # q 2048x2048, k and v 2048x1024, o 2048x2048, gate/up 2048x6144,
    # down 6144x2048.
    want = 2048 * 2048 * 2 + 2048 * 1024 * 2 + 3 * 2048 * 6144
    assert MODEL.layer_matmul_params(QWEN) == want == 50_331_648


def test_made_weights_have_the_published_parameter_count():
    import torch
    cfg = dict(QWEN, num_hidden_layers=1, vocab_size=1000)
    w = MODEL.make_weights(cfg, 5, torch.device("cpu"))
    layer = sum(t.numel() for n, t in w.items() if n.startswith("layers.0."))
    assert layer == 50_331_648 + 2 * 128 + 2 * 2048
    assert w["embed"].shape == (1000, 2048) and w["head"].shape == (2048, 1000)
    assert w["embed"].dtype == torch.bfloat16
    assert w["final_norm"].dtype == torch.float32


def test_train_step_flops_by_hand():
    b, t = 8, 2048
    weights = 28 * 50_331_648 + 2048 * 151_936
    pairs = t * (t + 1) // 2
    attn_fwd = 28 * 4 * 128 * 16 * b * pairs
    assert MODEL.train_step_flops(QWEN, b, t) == (6 * weights * b * t
                                                  + 3 * attn_fwd)
    assert MODEL.train_step_flops(QWEN, b, t) == pytest.approx(1.81e14,
                                                               rel=0.01)


def test_prefill_flops_by_hand():
    n = 1000
    want = (2 * 28 * 50_331_648 * n + 2 * 2048 * 151_936
            + 28 * 4 * 128 * 16 * (n * (n + 1) // 2))
    assert MODEL.prefill_flops(QWEN, n) == want


def test_flash_counts_by_hand():
    f, b = flops.flash_fwd(2, 4, 4, 2, 1, 8)
    assert f == 4 * 8 * 2 * 2 * 10          # 10 causal pairs of 4
    assert b == 2 * 2 * 8 * (2 * 4 * 2 + 2 * 4 * 1)
    f, b = flops.flash_bwd(2, 4, 4, 2, 1, 8)
    assert f == 10 * 8 * 2 * 2 * 10
    assert b == 2 * 2 * 8 * (4 * 4 * 2 + 4 * 4 * 1)


def test_roofline_share_takes_the_binding_bound():
    # 1e12 FLOPs at 1e12/s bound the time at 1 s; bytes bound it at 2 s.
    assert flops.roofline_share(1e12, 2e12, 4.0, 1e12, 1e12) == 50.0
    assert flops.roofline_share(3e12, 1e12, 3.0, 1e12, 1e12) == 100.0


def ctx(**kw):
    base = {"config": QWEN, "model": MODEL,
            "mix": {"batch": 8, "seq_len": 2048},
            "window": {}, "trace": {}}
    base.update(kw)
    return types.SimpleNamespace(**base)


def reader(name):
    return harness.load_file(harness.BENCH_DIR / "metrics" / f"{name}.py")


def test_mfu_train_reader():
    step = MODEL.train_step_flops(QWEN, 8, 2048)
    got = reader("mfu.train").read(ctx(window={"units": 10,
                                               "seconds": 20.0}))
    assert got == pytest.approx(100 * 10 * step / (peaks.BF16_FLOPS * 20))


def test_roofline_readers_say_nothing_without_device_time():
    trace = {"counters": {"flash_fwd": 0, "flash_bwd": 0},
             "device_s_by_op": {}, "calls": {}}
    for name in ("flash_bwd_roofline", "flash_fwd_roofline.train",
                 "flash_fwd_roofline.prefill"):
        assert reader(name).read(ctx(trace=trace)) is None


SHAPE = (8, 2048, 2048, 16, 8, 128)


def test_flash_bwd_reader_counts_launches_over_kernel_time():
    f, b = flops.flash_bwd(*SHAPE)
    trace = {"counters": {"flash_bwd": 28},
             "calls": {"flash_fwd": [SHAPE] * 56},
             "device_s_by_op": {"void flash_attention_bwd_dq_tc<128>()": 0.1,
                                "flash_attention_bwd_dkdv_tc": 0.1,
                                "nvjet_gemm": 5.0}}
    got = reader("flash_bwd_roofline").read(ctx(trace=trace))
    want = 100 * max(28 * f / peaks.BF16_FLOPS, 28 * b / peaks.HBM_BYTES) / 0.2
    assert got == pytest.approx(want)
    mixed = dict(trace, calls={"flash_fwd": [SHAPE, (1,) + SHAPE[1:]]})
    assert reader("flash_bwd_roofline").read(ctx(trace=mixed)) is None


@pytest.mark.parametrize("name", ["flash_fwd_roofline.train",
                                  "flash_fwd_roofline.prefill"])
def test_flash_fwd_readers_count_each_recorded_call(name):
    calls = [SHAPE, (2, 512, 512, 16, 8, 128)]
    trace = {"counters": {}, "calls": {"flash_fwd": calls},
             "device_s_by_op": {"flash_attention_tc<128>": 0.002,
                                "flash_attention_kernel": 0.001,
                                "nvjet_gemm": 5.0}}
    f = flops.flash_fwd(*calls[0])[0] + flops.flash_fwd(*calls[1])[0]
    got = reader(name).read(ctx(trace=trace))
    assert got == pytest.approx(100 * f / peaks.BF16_FLOPS / 0.003)


def test_mfu_prefill_reader():
    win = {"prompt_lengths": [100, 300], "seconds": 2.0}
    work = MODEL.prefill_flops(QWEN, 100) + MODEL.prefill_flops(QWEN, 300)
    assert reader("mfu.prefill").read(ctx(window=win)) == pytest.approx(
        100 * work / (peaks.BF16_FLOPS * 2.0))


class Event:
    def __init__(self, name, start, end, cuda):
        from torch.autograd import DeviceType
        self.name = name
        self.time_range = types.SimpleNamespace(start=start, end=end)
        self.device_type = DeviceType.CUDA if cuda else DeviceType.CPU


def test_read_trace_unions_device_work_and_labels_gaps():
    events = [Event(harness.SEGMENT, 0, 100, False),
              Event(harness.SEGMENT, 0, 100, True),
              Event("pipeline", 0, 30, False),
              Event("pipeline", 0, 30, True),     # the range's mirror
              Event("train_step", 30, 100, False),
              Event("gemm", 10, 20, True),
              Event("gemm", 15, 25, True),
              Event("softmax", 40, 90, True)]
    got = harness.read_trace(events, {"pipeline", "train_step"})
    assert got["window_s"] == pytest.approx(100e-6)
    assert got["busy_s"] == pytest.approx(65e-6)
    assert got["device_s_by_op"]["gemm"] == pytest.approx(20e-6)
    gaps = dict(got["breakdown"]["idle_gaps"])
    assert gaps["pipeline"] == pytest.approx(10e-6)
    assert gaps["train_step"] == pytest.approx(25e-6)
    idle = reader("idle_share.train").read(ctx(trace=got))
    assert idle == pytest.approx(35.0)
