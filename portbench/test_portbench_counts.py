"""The operation and byte counts against hand counts at small shapes, and
the trace reduction on a made-up timeline."""

import pytest

from portbench.harness import peaks, readers, trace
from portbench.harness.runner import Run
from portbench.reference import kernels, mfmf, vit


def test_attention_forward_by_hand():
    # 4 * H * hd * Tq * keys; q and o [b, tq, h, hd], k and v over the kept
    # keys, m and l float32 [b, h, tq], one byte a key of mask
    assert kernels.attention_fwd(2, 2, 3, 5, 4) == (960.0, 1120.0)
    assert kernels.attention_fwd(2, 2, 3, 5, 4, kept_keys=7, masked=True) == (672.0, 938.0)


def test_attention_backward_by_hand():
    assert kernels.attention_bwd(2, 2, 3, 5, 4) == (2400.0, 2000.0)


TINY = {"model": {
    "input_dim": 3, "output_dim": 4, "attention_num_heads": 2, "attention_widening_factor": 1,
    "n_classes": 2, "channel_input_dims": {"clinical=val": 2},
    "channels_used_in_model": ["wsi=features", "wsi=reconstructed_features", "tma=a=features",
                               "tma=b=features", "clinical=val"],
    "fusion_blocks_sequence": [{"q": "tma", "kv": "other"}, {"q": "result", "kv": "wsi"},
                               {"q": "reconstruct", "kv": "result"}]}}
WINDOW = {"wsi": [5], "tma": [[2, 3]], "pad": {"wsi": 8, "tma": 4}}


def test_mfmf_counts_by_hand():
    # forward: transfer 2*3*4*(5+5+5) + 2*2*4 = 376; blocks 128 Nq + 64 Nk +
    # 16 Nq Nk: (5, 1) 784, (5, 5) 1360, (5, 5) 1360; head 16; training
    # twice the forward again, the transfer layers' inputs excepted
    work = mfmf.count(TINY, WINDOW)
    assert work["flops"] == 2 * 376 + 3 * (784 + 1360 + 1360 + 16)
    # K3 at the padded shapes: the TMA modality 2 markers x 4 rows
    assert work["kernels"]["k3"] == [(128.0, 416.0), (640.0, 552.0), (640.0, 552.0)]
    assert work["kernels"]["k4"][1] == kernels.attention_bwd(1, 2, 8, 8, 2, kept_keys=5, masked=True)


VIT = {"model": {"img_size": 32, "patch_size": 16, "embed_dim": 32, "depth": 2, "num_heads": 2,
                 "mlp_ratio": 4.0},
       "extraction": {"patch_size": 48, "stride": 16, "batch_size": 4}}


def test_vit_counts_by_hand():
    # resize 2*3*32*48*(48+32), embedding 2*4*(16*16*3)*32, two blocks of
    # 2*5*32*(96+32+256) + 4*25*32
    assert vit.patch_flops(VIT, 48) == 737280 + 196608 + 2 * 126080
    work = vit.count(VIT, {"patches": [6, 9]})
    assert work["flops"] == 15 * vit.patch_flops(VIT, 48)
    assert work["kernels"]["k3"] == [kernels.attention_fwd(4, 2, 5, 5, 16)] * (2 * (2 + 3))


def _run(**fields):
    defaults = dict(cell=None, peaks=None, dtype="float32", setup_s=1.0, window_s=1.0, units=0,
                    spans={}, work={}, calls={})
    return Run(**{**defaults, **fields})


@pytest.mark.parametrize("k3_calls,units,share", [
    (2 * 5, 15, 25.0),  # 5 batches of 4 rows over two blocks: 20 rows, 15 real
    (2 * 4, 15, 6.25),  # packed across cores: 16 rows, 15 real
    (2 * 5 + 1, 15, None),  # no whole number of batches
    (2 * 3, 15, None),  # fewer rows than patches
    (0, 0, None),  # no K3 call (off the card)
])
def test_pad_share_from_the_program_calls(k3_calls, units, share):
    value = readers.pad_share(_run(units=units, calls={"k3": k3_calls}), 2, 4)
    assert value == (None if share is None else pytest.approx(share))


def _traced(op_n, calls):
    return trace.Trace(window_s=1.0, busy_s=0.5, op_s={name: 1e-3 for name in op_n}, op_n=op_n,
                       gaps_s={}, calls=calls)


@pytest.mark.parametrize("op_n,calls,counted,read", [
    ({"attn_bwd_dkdv_kernel<16>": 3, "attn_bwd_dq_kernel<16>": 3}, 3, 3, True),  # 2 a call
    ({"attn_bwd_dkdv_kernel<16>": 3, "attn_bwd_dq_kernel<16>": 3}, 3, 2, False),  # miscounted
    ({"attn_bwd_dkdv_kernel<16>": 3, "attn_bwd_dq_kernel<16>": 2}, 3, 3, False),  # 5 of 6 traced
    ({"attn_bwd_dkdv_kernel<16>": 2}, 3, 3, False),  # fewer launches than calls
])
def test_a_roofline_needs_the_count_to_be_the_programs(op_n, calls, counted, read):
    run = _run(peaks=peaks.peaks("NVIDIA H100 80GB HBM3"), trace=_traced(op_n, {"k4": calls}),
               trace_work={"kernels": {"k4": [(1e9, 1e6)] * counted}})
    value = readers.roofline(run, "k4")
    assert (value is not None) == read
    if read:
        assert value == pytest.approx(100.0 * 3 * peaks.bound_s(1e9, 1e6, run.peaks, "float32")
                                      / (2 * 1e-3))


class _Event:
    def __init__(self, name, start, dur, kind):
        self._n, self._s, self._d, self._k = name, start, dur, kind

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def activity_type(self):
        return self._k

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CPU if self._k in ("cpu_op", "user_annotation") else DeviceType.CUDA


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type("K", (), {"events": lambda s: events})()})()


def test_trace_reduction_by_hand():
    events = [
        _Event(trace.STEP, 0, 100, "user_annotation"),
        _Event("aten::copy_", 10, 30, "cpu_op"),
        _Event("k1", 20, 10, "kernel"),
        _Event("k2", 25, 10, "kernel"),  # overlaps k1: busy 20..35
        _Event("k1", 60, 20, "kernel"),
        _Event(trace.STEP, 0, 100, "gpu_user_annotation"),  # not device work
    ]
    busy, op_s, op_n, gaps = trace.reduce(_Prof(events))
    assert busy == 35
    assert op_s == pytest.approx({"k1": 30e-9, "k2": 10e-9})
    # 0..20 before the first op (copy_ open at 10) and 35..60 (nothing but the step)
    assert gaps == pytest.approx({"aten::copy_": 20e-9, trace.STEP: 25e-9})
