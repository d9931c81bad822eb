"""The port's serve CLI on the CPU: same summary keys as the reference,
the paged decode path, incremental chunked prefill, the disk KV tier and
the async copy-stage data plane, the fleet, peer and disaggregated runs,
and the flag combinations the reference refuses refused."""
from __future__ import annotations

import pytest

pytest.importorskip("torch")

from repro_torch.launch import serve  # noqa: E402

ARGS = ["--device", "cpu", "--requests", "4", "--max-seq", "48"]


def _summary(main, argv, capsys):
    import json
    main(argv)
    return json.loads(capsys.readouterr().out)


def test_summary_keys_match_reference(capsys):
    pytest.importorskip("jax")
    from repro.launch import serve as ref_serve

    got = _summary(serve.main, ARGS + ["--host-kv-gb", "0.0001"], capsys)
    want = _summary(ref_serve.main, ARGS[2:] + ["--host-kv-gb", "0.0001"],
                    capsys)
    assert sorted(got) == sorted(want)
    assert got["decode_path"] == "paged"
    assert got["finished"] + got["rejected"] == 4 and got["finished"] > 0
    # same policy code, same modeled clock
    for key in ("finished", "rejected", "tokens", "wall_modeled_s",
                "link_bytes", "host_kv_peak_pages", "streamed_pages_peak"):
        assert got[key] == want[key], key


def test_metrics_out_audits_clean(tmp_path, capsys):
    path = tmp_path / "trace.json"
    got = _summary(serve.main, ARGS + ["--preemption", "--prefix-dedup",
                                       "--metrics-out", str(path)], capsys)
    assert got["audit"]["ok"] and path.exists()


@pytest.mark.parametrize("flag", [
    ["--fleet", "2", "--peer"], ["--peer", "--autotune"], ["--disagg"],
    ["--disagg", "--host-kv-gb", "0.0001", "--prefill-instances", "0"],
    ["--fleet", "2", "--router", "round_robin", "--autotune"],
])
def test_unported_flags_refused(flag, capsys):
    """The fleet, peer and disaggregated flags are ported; what the
    reference's serve refuses of them, the port refuses the same way."""
    pytest.importorskip("jax")
    from repro.launch import serve as ref_serve

    errs = []
    for main, argv in ((serve.main, ARGS + flag), (ref_serve.main,
                                                   ARGS[2:] + flag)):
        with pytest.raises(SystemExit) as exc:
            main(argv)
        assert exc.value.code == 2
        errs.append(capsys.readouterr().err.splitlines()[-1])
    assert errs[0] == errs[1]


@pytest.mark.parametrize("flags", [
    ["--fleet", "2"], ["--fleet", "2", "--router", "round_robin"],
    ["--disagg", "--host-kv-gb", "0.0001"], ["--peer"],
])
def test_fleet_cli_matches_reference(flags, capsys):
    """The fleet, disaggregated and peer runs: the same summary keys and
    the same policy outcomes as the reference's serve, audits clean."""
    pytest.importorskip("jax")
    from repro.launch import serve as ref_serve

    got = _summary(serve.main, ARGS + flags, capsys)
    want = _summary(ref_serve.main, ARGS[2:] + flags, capsys)
    assert sorted(got) == sorted(want)
    keys = ("finished", "rejected", "tokens", "wall_modeled_s",
            "link_bytes", "migrations", "handoffs", "reroutes",
            "per_instance", "audit")
    for key in keys:
        assert got.get(key) == want.get(key), key
    assert got["finished"] == 4
    if "audit" in got:
        assert got["audit"]["ok"]
    if "--disagg" in flags:
        assert got["handoffs"] > 0


DISK = ["--host-kv-gb", "0.0001", "--disk-kv-gb", "0.0001", "--preemption"]


def test_three_tier_cli_matches_reference(capsys):
    """``--disk-kv-gb`` runs the third tier: the summary reports three
    tiers and the disk peak, and the modeled clock and link bytes equal
    the reference CLI's on the same flags."""
    pytest.importorskip("jax")
    from repro.launch import serve as ref_serve

    got = _summary(serve.main, ARGS + DISK, capsys)
    want = _summary(ref_serve.main, ARGS[2:] + DISK, capsys)
    assert got["kv_tiers"] == want["kv_tiers"] == 3
    assert "disk_kv_peak_pages" in got
    assert got["data_plane"]["async"] is False
    for key in ("finished", "rejected", "tokens", "wall_modeled_s",
                "link_bytes", "host_kv_peak_pages", "disk_kv_peak_pages",
                "disk_demotions", "disk_stagings", "preemptions"):
        assert got[key] == want[key], key


def test_async_data_plane_cli_tokens_equal_sync(monkeypatch, capsys):
    """``--async-data-plane`` serves the same tokens and modeled clock as
    the synchronous plane, and reports its copy wall counters."""
    engines = []
    build = serve.build_engine

    def keep(*a, **kw):
        engines.append(build(*a, **kw))
        return engines[-1]

    monkeypatch.setattr(serve, "build_engine", keep)
    sync = _summary(serve.main, ARGS + DISK, capsys)
    asyn = _summary(serve.main, ARGS + DISK + ["--async-data-plane"], capsys)
    assert asyn["data_plane"]["async"] is True and asyn["kv_tiers"] == 3
    assert asyn["data_plane"]["blocking_copy_s"] >= 0.0
    assert asyn["data_plane"]["background_copy_s"] >= 0.0
    assert asyn["wall_modeled_s"] == sync["wall_modeled_s"]
    s_eng, a_eng = engines
    assert a_eng.data_plane.async_mode and not s_eng.data_plane.async_mode
    assert {r.rid: r.generated for r in a_eng.finished} == \
        {r.rid: r.generated for r in s_eng.finished}
    assert a_eng.data_plane.inflight_pages() == 0


def test_disk_backing_path_cli(tmp_path, capsys):
    """``--disk-backing-path`` maps the disk pool onto a file of the pool's
    size (bf16 pages)."""
    path = tmp_path / "kv_disk.bin"
    got = _summary(serve.main, ARGS + DISK + ["--disk-backing-path",
                                              str(path)], capsys)
    assert got["kv_tiers"] == 3 and got["finished"] > 0
    assert path.exists() and path.stat().st_size > 0


def test_cli_refuses_disk_tier_without_host_tier(capsys):
    with pytest.raises(SystemExit) as exc:
        serve.main(ARGS + ["--disk-kv-gb", "0.001"])
    assert exc.value.code == 2
    assert "--host-kv-gb" in capsys.readouterr().err


def test_profile_trace_summary_unions_device_spans():
    """The device-coverage arithmetic of ``launch/profile_engine`` (whose
    run needs a GPU): overlapping kernel and copy spans count once."""
    from repro_torch.launch.profile_engine import trace_summary

    ev = lambda cat, name, ts, dur: dict(ph="X", cat=cat, name=name, ts=ts,
                                         dur=dur)
    trace = {"traceEvents": [ev("kernel", "a", 0, 2), ev("kernel", "a", 10, 2),
                             ev("kernel", "b", 1, 5), ev("gpu_memcpy", "m",
                                                         4, 3),
                             ev("cpu_op", "x", 0, 100)]}
    out = trace_summary(trace, wall_us=20.0)
    assert out["kernel_ms"] == pytest.approx(0.008)      # [0,6) + [10,12)
    assert out["copy_ms"] == pytest.approx(0.003)
    assert out["busy_ms"] == pytest.approx(0.009)        # [0,7) + [10,12)
    assert out["copy_kernel_overlap_ms"] == pytest.approx(0.002)   # [4,6)
    assert out["idle_share"] == pytest.approx(1 - 9 / 20)
    assert [k["name"] for k in out["top_kernels"]] == ["b", "a"]
    assert out["kernel_launches"] == 3


def test_profile_trace_summary_paged_decode_share():
    """The paged decode attention's share of kernel time sums both of its
    kernels, the split and the in-order combine."""
    from repro_torch.launch.profile_engine import trace_summary

    ev = lambda name, ts, dur: dict(ph="X", cat="kernel", name=name, ts=ts,
                                    dur=dur)
    split = "(anonymous namespace)::decode_split_kernel(__nv_bfloat16 const*)"
    combine = "(anonymous namespace)::decode_combine_kernel(float const*)"
    trace = {"traceEvents": [ev(split, 0, 6), ev(combine, 6, 2),
                             ev("ampere_bf16_gemm", 8, 12), ev(split, 20, 4),
                             ev(combine, 24, 1)]}
    out = trace_summary(trace, wall_us=50.0)
    assert out["paged_decode_ms"] == pytest.approx(0.013)
    assert out["paged_decode_share_of_kernel_time"] == pytest.approx(13 / 25)


def test_profile_trace_summary_paged_chunk_share():
    """The incremental profile's chunk-attention share sums the chunk
    kernel's split and combine, apart from the paged decode's kernels."""
    from repro_torch.launch.profile_engine import trace_summary

    ev = lambda name, ts, dur: dict(ph="X", cat="kernel", name=name, ts=ts,
                                    dur=dur)
    split = "void (anonymous namespace)::chunk_split_kernel<128>(int)"
    combine = "(anonymous namespace)::chunk_combine_kernel(float const*)"
    decode = "(anonymous namespace)::decode_split_kernel(__nv_bfloat16*)"
    trace = {"traceEvents": [ev(split, 0, 9), ev(combine, 9, 3),
                             ev(decode, 12, 4), ev("nvjet_tst", 16, 24)]}
    out = trace_summary(trace, wall_us=80.0)
    assert out["paged_chunk_ms"] == pytest.approx(0.012)
    assert out["paged_chunk_share_of_kernel_time"] == pytest.approx(12 / 40)
    assert out["paged_decode_ms"] == pytest.approx(0.004)


@pytest.mark.parametrize("field,value", [("role", "prefill")])
def test_engine_refuses_unported_settings(field, value):
    """The fleet roles are ported: a prefill-role engine builds and holds
    its parked requests for handoff; a role the fleet does not know is
    refused, as in the reference."""
    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduce_config
    from repro_torch.core.hardware import A10
    from repro_torch.serving.engine import EngineConfig

    cfg = reduce_config(get_config("qwen2.5-3b"))
    eng = serve.build_engine("x", cfg, A10, EngineConfig(
        max_batch=2, max_seq=32, **{field: value}), [0.01], device="cpu")
    assert eng.role == value and eng.scheduler.hold_resumes
    with pytest.raises(ValueError, match="role"):
        serve.build_engine("y", cfg, A10, EngineConfig(
            max_batch=2, max_seq=32, **{field: "bogus"}), [0.01],
            device="cpu")


@pytest.mark.parametrize("async_plane", [False, True])
def test_engine_accepts_disk_tier_and_async_plane(async_plane):
    """The constructor builds the disk pool (a CPU bf16 tensor of the
    tier's pages) and the copy-stage plane, and wires the allocator's copy
    hooks into it; ``async_data_plane`` alone, without a disk tier, leaves
    the plane out, as in the reference."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduce_config
    from repro_torch.core.hardware import A10
    from repro_torch.serving.engine import EngineConfig

    cfg = reduce_config(get_config("qwen2.5-3b"))
    base = dict(max_batch=2, max_seq=32, hbm_budget_bytes=1e9,
                async_data_plane=async_plane)
    eng = serve.build_engine("x", cfg, A10, EngineConfig(
        host_kv_bytes=1e6, disk_kv_bytes=1e6, **base), [0.01], device="cpu")
    plane = eng.data_plane
    assert plane is not None and plane.async_mode is async_plane
    assert plane.host_pool is eng.host_pool and plane.disk_pool is \
        eng.disk_pool
    assert eng.disk_pool.dtype == torch.bfloat16
    assert eng.disk_pool.shape == (eng.kv.disk.total_pages, *eng.page_shape)
    for hook in ("disk_copy", "park_copy", "promote_copy", "direct_copy"):
        assert getattr(eng.kv, hook) is not None, hook
    bare = serve.build_engine("y", cfg, A10, EngineConfig(**base), [0.01],
                              device="cpu")
    assert bare.data_plane is None and bare.disk_pool is None
    assert bare._trace_footer()["staged_issued_pages_total"] == 0


def test_engine_refuses_incremental_prefill_with_prefix_dedup():
    """The reference's own limit: deduped chunk pages would need
    skip-write/COW handling inside the chunk path."""
    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduce_config
    from repro_torch.core.hardware import A10
    from repro_torch.serving.engine import EngineConfig

    ecfg = EngineConfig(max_batch=2, max_seq=32, prefill_chunk_tokens=16,
                        incremental_prefill=True, prefix_dedup=True)
    with pytest.raises(NotImplementedError, match="prefix dedup"):
        serve.build_engine("x", reduce_config(get_config("qwen2.5-3b")), A10,
                           ecfg, [0.01], device="cpu")


def test_cli_rejects_incremental_prefill_with_prefix_dedup(capsys):
    with pytest.raises(SystemExit) as exc:
        serve.main(ARGS + ["--prefill-chunk-tokens", "16",
                           "--incremental-prefill", "--prefix-dedup"])
    assert exc.value.code == 2
    assert "--prefix-dedup" in capsys.readouterr().err


@pytest.mark.parametrize("edit", ["sliding_window", "recurrent_mixer"])
def test_chunk_block_refuses_what_the_kernel_lacks(edit):
    """The chunk kernel has no window mask and no recurrent state: the
    block refuses both before touching the pool, as the reference does."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import BlockSpec
    from repro_torch.configs.reduced import reduce_config
    from repro_torch.models import transformer as T

    cfg = reduce_config(get_config("qwen2.5-3b"))
    blk = cfg.pattern[0]
    if edit == "sliding_window":
        cfg = dataclasses.replace(cfg, sliding_window=8)
    else:
        blk = BlockSpec(mixer="mamba")
    pool = torch.zeros((2, 8, cfg.num_layers, 2, 2, 4))
    x = torch.zeros((1, 3, cfg.d_model))
    with pytest.raises(NotImplementedError, match="paged chunk prefill"):
        T.apply_block_prefill_paged(
            cfg, blk, {}, x, 0, pool, 0, torch.zeros(2, dtype=torch.int32),
            3, torch.zeros(3, dtype=torch.long),
            torch.arange(3), 2)
    assert torch.count_nonzero(pool) == 0


def test_incremental_chunk_without_its_pages_falls_back():
    """A chunk whose pages are not all allocated leaves the incremental
    path (None: the engine recomputes it instead, as the reference does)
    having computed, timed and written nothing."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduce_config
    from repro_torch.core.hardware import A10
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import PrefillChunk

    ecfg = EngineConfig(max_batch=2, max_seq=32, page_size=8,
                        hbm_budget_bytes=1e9, prefill_chunk_tokens=8,
                        incremental_prefill=True)
    eng = serve.build_engine("x", reduce_config(get_config("qwen2.5-3b")),
                             A10, ecfg, [0.01], device="cpu")
    req = Request(rid=0, prompt=np.arange(20, dtype=np.int32),
                  max_new_tokens=2, ttft_slo_s=1.0, tpot_slo_s=1.0)
    assert eng.kv.alloc(0, 8) is not None          # one page of the three
    pool = eng.pool.clone()
    assert eng._run_chunk_incremental(PrefillChunk(req, 0, 8, 16)) is None
    assert eng.prefill_tokens_computed == 0 and not eng.chunk_ms
    assert torch.equal(eng.pool, pool)


def test_incremental_prefill_cli_matches_reference(capsys):
    """``--prefill-chunk-tokens 16 --incremental-prefill`` with a host tier
    through the port's CLI: the same summary as the reference's CLI on the
    modeled clock, with the chunked prefill engaged."""
    pytest.importorskip("jax")
    from repro.launch import serve as ref_serve

    argv = ["--max-seq", "64", "--requests", "4", "--host-kv-gb", "0.0001",
            "--prefill-chunk-tokens", "16", "--incremental-prefill"]
    got = _summary(serve.main, ["--device", "cpu"] + argv, capsys)
    want = _summary(ref_serve.main, argv, capsys)
    assert got["data_plane"]["incremental_prefill"]
    assert got["finished"] > 0 and got["chunked_prefill_iters"] > 0
    for key in ("finished", "rejected", "tokens", "wall_modeled_s",
                "link_bytes", "host_kv_peak_pages", "streamed_pages_peak",
                "chunked_prefill_iters"):
        assert got[key] == want[key], key


def test_engine_holds_the_current_intervals_placement():
    """One placement at a time, rebuilt on an interval switch; its resident
    units and tail are the plan's device units less the two-slot ring,
    which exists only on a GPU (``tests/test_torch_cuda.py`` checks the
    card's memory)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.reduced import reduce_config
    from repro_torch.core import costs
    from repro_torch.core.hardware import A10
    from repro_torch.core.interval import NO_OFFLOAD
    from repro_torch.models.spec import tree_leaves
    from repro_torch.serving.engine import EngineConfig

    cfg = reduce_config(get_config("qwen2.5-3b"))
    eng = serve.build_engine("x", cfg, A10, EngineConfig(
        max_batch=2, max_seq=32, hbm_budget_bytes=1e9), [0.01], device="cpu")
    unit = costs.unit_weight_bytes(cfg)
    nbytes = lambda tree: sum(t.numel() * t.element_size()
                              for t in tree_leaves(tree))
    for iv in (NO_OFFLOAD, 1, 2, NO_OFFLOAD):
        assert eng.set_interval(iv)
        rt, placed = eng._rt()
        assert rt.plan.interval == iv and eng._rt()[0] is rt
        ring = 2 * unit if rt.plan.enabled else 0
        blk = placed["blocks"]
        assert nbytes(blk["resident"]) + nbytes(blk["tail"]) + ring == \
            rt.plan.device_bytes(unit)
        # nothing is pinned or prefetched on the CPU
        assert eng.host_weight_bytes == 0 and eng.prefetch_copies == 0


def test_calibrated_preset_on_the_cli(capsys):
    """``--hw h100_calibrated`` serves with the clock fitted on the card."""
    got = _summary(serve.main, ARGS + ["--hw", "h100_calibrated"], capsys)
    assert got["finished"] + got["rejected"] == 4 and got["finished"] > 0


@pytest.mark.parametrize("arch", ["dbrx-132b", "grok-1-314b"])
def test_moe_cli_matches_reference(arch, capsys):
    """``--arch`` of a MoE decoder serves at the reduced width, as the
    reference's serve does: the same summary keys, and the same policy
    outcomes and modeled clock."""
    pytest.importorskip("jax")
    from repro.launch import serve as ref_serve

    flags = ["--arch", arch, "--host-kv-gb", "0.0001"]
    got = _summary(serve.main, ARGS + flags, capsys)
    want = _summary(ref_serve.main, ARGS[2:] + flags, capsys)
    assert sorted(got) == sorted(want)
    assert got["finished"] + got["rejected"] == 4 and got["finished"] > 0
    for key in ("finished", "rejected", "tokens", "slo_ok",
                "wall_modeled_s", "link_bytes", "host_kv_peak_pages",
                "streamed_pages_peak", "decode_path", "autotune_enabled"):
        assert got[key] == want[key], key
