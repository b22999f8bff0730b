"""The port's measuring tools (``semi_seg_ecg_tpu_torch/tools/``) on the CPU.

Each tool's ``main`` runs in this process at a tiny shape with
``--device cpu`` (a rehearsal): its last line of output is one JSON
object with the tool's keys, the device named (platform ``cpu``, no kind,
no count, no power limit), and every device metric (time, rate, idle
share, MFU, peak memory) null, since a CPU's times are no card's. Without
``--device cpu`` a tool asks for the card and raises where there is none.
``tools/device_profile.py``'s peaks apply to an H100 with HBM3 only; its
rollup sorts the port's kernels and the libraries' by name; its Chrome
trace reader counts a trace's device events. The tools' card runs are
``tests/test_torch_cuda.py``'s and ``chip_smoke.py`` phase 21's.
"""

import contextlib
import io
import json
import math

import pytest
import torch

from semi_seg_ecg_tpu_torch.tools import (
    bench,
    bench_e2e,
    bench_holter,
    bench_inference,
    bench_longrec,
    bench_matrix,
    bench_scale,
    bench_streams,
    device_profile,
    flops_audit,
    profile_step,
)
from tests.torch_dist_worker import one_thread  # noqa: F401 (autouse)

CPU = {"platform": "cpu", "kind": None, "count": 0, "power_limit": None}
ROW_NULLS = ("samples_per_sec", "ms_per_step", "trials_ms", "spread", "mfu",
             "device_busy_ms_per_step", "device_idle_share")
LONGREC = ["--t", "512", "--steps", "1", "--depth", "2", "--width", "32",
           "--heads", "2", "--dim-head", "16", "--mlp-dim", "64"]

# tool: (argv at a tiny shape, top-level keys, keys null on the CPU, the
# keys of the rows under "rows" / "all_modes" / "sweep" null on the CPU)
TOOLS = {
    "flops_audit": (flops_audit, ["--batch", "1"],
                    ("metric", "flops_per_step", "by_op",
                     "top_contributors"), (), ()),
    "bench": (bench, ["--steps", "1", "--batch", "1", "--length", "128"],
              ("metric", "value", "unit", "vs_baseline", "mfu",
               "flops_per_step", "mode", "device_idle_share",
               "device_kind", "all_modes", "peak", "baseline"),
              ("value", "vs_baseline", "mfu", "device_idle_share",
               "device_kind"), ROW_NULLS),
    "bench_scale": (bench_scale, ["--batches", "1", "--modes", "1", "2",
                                  "--steps", "1", "--length", "128"],
                    ("metric", "sweep"), (), ROW_NULLS),
    "bench_matrix": (bench_matrix, ["--steps", "1", "--batch", "1",
                                    "--length", "128"],
                     ("metric", "rows"), (),
                     ("ms_per_step", "samples_per_sec")),
    "profile_step": (profile_step, ["--steps", "1", "--batch", "1",
                                    "--length", "250", "--augment"],
                     ("metric", "label", "wall_ms_per_step",
                      "device_busy_ms_per_step", "device_idle_share",
                      "launches_in_window", "kernel_events_in_window",
                      "categories_ms_per_step", "top_kernels"),
                     ("wall_ms_per_step", "device_busy_ms_per_step",
                      "device_idle_share", "device_events_per_step"), ()),
    "bench_e2e": (bench_e2e, ["--records", "16", "--epochs", "2",
                              "--warm", "1", "--length", "250",
                              "--scan-steps", "2",
                              "--modes", "host,cache+scan"],
                  ("metric", "results", "rows", "records"), (),
                  ("samples_per_sec", "sec_per_epoch", "epoch_times_s")),
    "bench_inference": (bench_inference, ["--batches", "1", "--steps", "1",
                                          "--length", "128", "--int8",
                                          "--static"],
                        ("metric", "rows"), (),
                        ("wall_ms", "windows_per_s", "device_busy_ms",
                         "device_idle_share", "device_events")),
    "bench_holter": (bench_holter, ["--hours", "0.006", "--batch", "4",
                                    "--reps", "1"],
                     ("metric", "value", "unit", "windows",
                      "seconds_per_record", "hours_of_ecg_per_s",
                      "peak_memory_mb"),
                     ("value", "seconds_per_record", "seconds_per_record_reps",
                      "first_record_s", "hours_of_ecg_per_s",
                      "windows_per_s", "peak_memory_mb"), ()),
    "bench_streams": (bench_streams, ["--streams", "2", "--reps", "1"],
                      ("metric", "value", "unit", "ms_per_step_dispatch",
                       "streams_at_dispatch_rate"),
                      ("value", "ms_per_step_dispatch", "ms_per_step_trials",
                       "streams_at_dispatch_rate"), ()),
    "bench_longrec_card": (bench_longrec, ["--mode", "card"] + LONGREC,
                           ("mode", "t", "tokens", "ms_per_step",
                            "peak_memory_mb", "launches_per_step",
                            "final_loss"),
                           ("ms_per_step", "first_step_s", "peak_memory_mb"),
                           ()),
    "bench_longrec_mem": (bench_longrec, ["--mode", "mem"] + LONGREC,
                          ("mode", "t", "rows"), (),
                          ("ms_per_step", "first_step_s", "peak_memory_mb")),
}


@pytest.fixture(scope="module")
def lines():
    """Each tool's last line, run once a module (lazily), at the small
    counts: one trial, one traced step, one warm-up step; the captured
    mode at K = 2 and the peak row at batch 2; ResNet18 alone in the
    matrix; the loaders in the training process."""
    cache = {}

    def line(name):
        if name not in cache:
            module, argv, *_ = TOOLS[name]
            out = io.StringIO()
            with pytest.MonkeyPatch.context() as mp, \
                    contextlib.redirect_stdout(out):
                mp.setattr(bench, "TRIALS", 1)
                mp.setattr(bench, "TRACE_STEPS", 1)
                mp.setattr(bench, "SCAN_K", 2)
                mp.setattr(bench, "PEAK_BATCH", 2)
                mp.setattr(bench_matrix, "MODELS", ["resnet18"])
                mp.setattr(bench_e2e, "WORKERS", 0)
                mp.setattr(bench_matrix, "WARMUP", 1)
                mp.setattr(profile_step, "WARMUP", 1)
                mp.setattr(bench_streams, "STEPS", 1)
                assert module.main(argv + ["--device", "cpu"]) == 0
            cache[name] = json.loads(out.getvalue().strip().splitlines()[-1])
        return cache[name]

    return line


def rows_of(out):
    rows = []
    for key in ("rows", "all_modes", "sweep"):
        rows += out.get(key) or []
    if out.get("peak"):
        rows.append(out["peak"])
    return rows


def finite_losses(obj):
    """Every ``*loss`` number in ``obj``, recursively."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            if k.endswith("loss") and isinstance(v, float):
                yield v
            else:
                yield from finite_losses(v)
    elif isinstance(obj, list):
        for v in obj:
            yield from finite_losses(v)


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_line_on_the_cpu(name, lines):
    _, _, keys, nulls, row_nulls = TOOLS[name]
    out = lines(name)
    assert set(keys) <= set(out), set(keys) - set(out)
    assert out["device"] == CPU
    for key in nulls:
        assert out[key] is None, key
    rows = rows_of(out)
    assert bool(rows) == bool(row_nulls)
    for row in rows:
        for key in row_nulls:
            assert row[key] is None, (key, row)
    assert all(math.isfinite(v) for v in finite_losses(out))


def test_bench_counts_the_step_and_both_modes(lines):
    out = lines("bench")
    assert [r["mode"] for r in out["all_modes"]] == ["per-step", "scan2"]
    assert out["peak"]["batch_per_replica"] == 2
    assert out["peak"]["flops_per_step"] == 2 * out["flops_per_step"]
    assert out["flops_per_step"] == flops_audit.step_flops(
        bench.build(1, 1, torch.device("cpu"), length=128)[0],
        torch.device("cpu"))


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_without_a_card_raises(name):
    if torch.cuda.is_available():
        pytest.skip("the card is there: the tool would measure it")
    module, argv, *_ = TOOLS[name]
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        module.main(argv)


@pytest.mark.parametrize("kind, peak", [
    ("NVIDIA H100 80GB HBM3", 989e12), ("NVIDIA H100 PCIe", None),
    ("NVIDIA A100-SXM4-80GB", None), (None, None)])
def test_peaks_are_the_h100_sxm_only(kind, peak):
    assert device_profile.peak_flops(kind) == peak
    want = None if peak is None else 1e12 / 1e-3 / peak
    assert device_profile.mfu(1e12, 1.0, kind) == want


@pytest.mark.parametrize("name, cat", [
    ("void flash_fwd_mma<64>(Tensor4, Tensor4)", "flash"),
    ("flash_bwd_dkdv_fp32", "flash"),
    ("void gather1d_kernel<int>(Lerp, Index<int>)", "gather"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "nccl"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16", "gemm_conv"),
    ("ampere_bf16_s16816gemm_bf16_128x64", "gemm_conv"),
    ("void at::native::elementwise_kernel<128, 2>", "elementwise_copy"),
    ("Memcpy HtoD (Pageable -> Device)", "elementwise_copy"),
    ("void at::native::reduce_kernel<512, 1>", "other")])
def test_rollup_categories(name, cat):
    assert device_profile.category(name) == cat


def test_trace_file_kernels(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [
        {"cat": "kernel", "name": "gather1d_kernel", "dur": 5.0},
        {"cat": "kernel", "name": "gather1d_kernel", "dur": 3.0},
        {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "dur": 2.0},
        {"cat": "cpu_op", "name": "aten::mm", "dur": 50.0}]}))
    ms, counts = device_profile.trace_file_kernels(str(path))
    assert ms == {"gather1d_kernel": 0.008, "Memcpy HtoD": 0.002}
    assert counts == {"gather1d_kernel": 2, "Memcpy HtoD": 1}
