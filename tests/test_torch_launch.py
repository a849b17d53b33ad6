"""The port's launch tools against the JAX package's: ``launch.analytic``
equal to the reference's float for float (same arithmetic, same order) on
every architecture x input shape x algorithm x bytes a value, the
parameter counts of the ten full-size configs equal the reference's
``jax.eval_shape`` counts; ``launch.roofline``'s terms, model FLOPs and
report line equal the reference's at the same rates, its card table
refuses unknown cards and its collective bytes read a gloo trace by the
reference's conventions; ``launch.dryrun`` on meta tensors at smoke size
(analytic fields equal the reference's, exact extrapolation of the cut
counts, the counted-to-analytic ratio of a dense prefill pinned, the pod
meshes and the reference's flags, each row's bytes a rank from the
reference's specs); ``launch.inspect_trace`` and
``launch.make_table`` on what the tools write.
"""

import functools
import json
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile, record_function

from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.core import prox as jprox
from repro.launch import analytic as janalytic
from repro.launch import mesh as jmesh
from repro.launch import roofline as jroofline
from repro.models import transformer as jtransformer
from repro.train import sharding as jsharding, steps as jsteps
from repro_torch import configs as tconfigs
from repro_torch.launch import analytic, dryrun, inspect_trace, make_table, \
    roofline
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer

torch.set_num_threads(1)

ARCHS = list(jconfigs.ARCHITECTURES)


# the reference's own counter, kept before any test patches the module
_REF_PARAM_COUNT = janalytic.param_count_analytic


@functools.lru_cache(maxsize=None)
def _ref_counts(arch):
    """The reference's (total, active) parameter counts (jax.eval_shape)."""
    cfg = jconfigs.get_config(arch)
    return _REF_PARAM_COUNT(cfg), janalytic.active_param_count(cfg)


def test_the_port_has_the_reference_grid():
    assert tconfigs.ARCHITECTURES == jconfigs.ARCHITECTURES
    assert {k: vars(v) for k, v in tconfigs.INPUT_SHAPES.items()} == \
        {k: vars(v) for k, v in jconfigs.INPUT_SHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_counts_equal_the_reference_eval_shape(arch):
    cfg = tconfigs.get_config(arch)
    assert (analytic.param_count_analytic(cfg),
            analytic.active_param_count(cfg)) == _ref_counts(arch)
    # the shape-only init is the tree the real init builds, on meta
    params = transformer.init_params(cfg, 0, "meta")
    assert all(t.is_meta for t in jax.tree.leaves(
        params, is_leaf=lambda x: isinstance(x, torch.Tensor)))


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_equals_the_reference_exactly(arch, monkeypatch):
    # the reference re-derives its parameter count with jax.eval_shape on
    # every step_bytes call: serve it from the cache (same numbers)
    monkeypatch.setattr(janalytic, "param_count_analytic",
                        lambda cfg: _ref_counts(cfg.name)[0])
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for name in jconfigs.INPUT_SHAPES:
        js, ts = jconfigs.INPUT_SHAPES[name], tconfigs.INPUT_SHAPES[name]
        assert analytic.forward_flops(tcfg, ts.seq_len, ts.global_batch,
                                      ts.kind) == janalytic.forward_flops(
            jcfg, js.seq_len, js.global_batch, js.kind)
        assert analytic._cache_bytes(tcfg, ts, 2) == \
            janalytic._cache_bytes(jcfg, js, 2)
        for algo in ("dpsvrg", "dspg"):
            assert analytic.step_flops(tcfg, ts, algo) == \
                janalytic.step_flops(jcfg, js, algo)
            for dtype_bytes in (2, 4):
                for m in (1, 16):
                    assert analytic.step_bytes(tcfg, ts, m, dtype_bytes,
                                               algo) == \
                        janalytic.step_bytes(jcfg, js, m, dtype_bytes, algo)
    # the reference's "dots" remat multiplier
    ts, js = tconfigs.INPUT_SHAPES["train_4k"], jconfigs.INPUT_SHAPES[
        "train_4k"]
    assert analytic.step_flops(tcfg.scaled(remat_policy="dots"), ts) == \
        janalytic.step_flops(jcfg.scaled(remat_policy="dots"), js)


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

def test_hw_holds_the_h100_sxm_rates():
    hw = roofline.HW()
    assert (hw.peak_flops("float32"), hw.peak_flops(torch.bfloat16),
            hw.hbm_bw, hw.link_bw, hw.chips) == (67e12, 989e12, 3.35e12,
                                                 450e9, 1)
    with pytest.raises(ValueError, match="float16"):
        hw.peak_flops(torch.float16)


@pytest.fixture
def fake_card(monkeypatch):
    """Makes ``torch.cuda.get_device_properties`` report a card name."""
    def install(name):
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda device=None: types.SimpleNamespace(
                                name=name, total_memory=80 * 2**30))
    return install


def test_from_device_reads_the_card_and_refuses_unknown_ones(fake_card):
    fake_card("NVIDIA H100 80GB HBM3")
    assert roofline.HW.from_device(0) == roofline.HW()
    for other in ("NVIDIA H100 PCIe", "NVIDIA H200", "Tesla V100-SXM2-16GB"):
        fake_card(other)
        with pytest.raises(ValueError, match=other):
            roofline.HW.from_device(0)


@pytest.mark.parametrize("arch,shape", [
    ("h2o-danube-1.8b", "prefill_32k"), ("h2o-danube-1.8b", "decode_32k"),
    ("llama4-scout-17b-a16e", "train_4k"), ("xlstm-350m", "long_500k"),
    ("whisper-base", "train_4k")])
@pytest.mark.parametrize("dtype,peak", [("bfloat16", 989e12),
                                        ("float32", 67e12)])
def test_roofline_terms_equal_the_reference(arch, shape, dtype, peak,
                                            monkeypatch):
    monkeypatch.setattr(janalytic, "param_count_analytic",
                        lambda cfg: _ref_counts(cfg.name)[0])
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    js, ts = jconfigs.INPUT_SHAPES[shape], tconfigs.INPUT_SHAPES[shape]
    active = _ref_counts(arch)[1]
    mfl = roofline.model_flops(tcfg, ts, active)
    assert mfl == jroofline.model_flops(jcfg, js, active)
    afl = janalytic.step_flops(jcfg, js)
    aby = janalytic.step_bytes(jcfg, js, 1, 4)
    jhw = jroofline.HW(peak_flops=peak, hbm_bw=3.35e12, link_bw=450e9,
                       chips=1)
    want = jroofline.roofline_terms(arch, shape, "h100x1", {}, "", jhw, mfl,
                                    afl, aby, note="n")
    got = roofline.roofline_terms(arch, shape, "h100x1", 0.0, 0.0, None,
                                  roofline.HW(), mfl, afl, aby, dtype=dtype,
                                  note="n")
    shared = ("arch", "shape", "mesh", "analytic_gflops", "analytic_gbytes",
              "coll_gbytes", "coll_breakdown", "t_compute", "t_memory",
              "t_collective", "bottleneck", "model_gflops", "useful_ratio",
              "bytes_per_device", "note")
    for field in shared:
        assert getattr(got, field) == getattr(want, field), field
    assert roofline.format_report(got) == jroofline.format_report(want)


def test_collective_bytes_of_a_trace_without_collectives(tmp_path):
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        torch.ones(64) @ torch.ones(64)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    out = roofline.collective_bytes(str(path))
    assert out["total"] == 0 and all(v == 0 for v in out.values())
    assert set(out) == set(jroofline.collective_bytes(""))


@pytest.fixture
def gloo_group():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _collective_trace(path):
    x = torch.ones(1000, dtype=torch.float32)
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        with record_function("comms"):
            dist.all_reduce(x)
            dist.all_gather([torch.empty(1000)], x)
    prof.export_chrome_trace(str(path))


def test_collective_bytes_counts_gloo_collectives(tmp_path, gloo_group):
    path = tmp_path / "trace.json"
    _collective_trace(path)
    out = roofline.collective_bytes(str(path))
    # the reference's conventions: an all-reduce counts its result (= the
    # operand), an all-gather its result (= operand x group, 1 here)
    assert out["all-reduce"] == 4000
    assert out["all-gather"] == 4000
    assert out["total"] == 8000
    assert out["reduce-scatter"] == out["all-to-all"] == \
        out["collective-permute"] == out["in_scan"] == 0
    # the group size comes from the caller where the trace lacks it
    assert roofline.collective_bytes(str(path), group_size=4)[
        "all-gather"] == 16000
    rows = inspect_trace.analyze(str(path))["all_collectives"]
    assert sorted((r["kind"], r["bytes"], r["type"]) for r in rows) == [
        ("all-gather", 4000, "float"), ("all-reduce", 4000, "float")]


def test_collective_bytes_reads_nccl_param_comms_events():
    # the fields torch's record_param_comms events carry (NCCL)
    def ev(name, out_n, dtype="BFloat16", group=4):
        return {"name": "record_param_comms", "cat": "cpu_op", "ts": 0,
                "dur": 1, "pid": 1, "tid": 1,
                "args": {"Collective name": name, "dtype": dtype,
                         "In msg nelems": out_n, "Out msg nelems": out_n,
                         "Group size": group}}
    trace = {"traceEvents": [ev("allreduce", 10), ev("_allgather_base", 40),
                             ev("reduce_scatter_tensor", 10),
                             ev("all_to_all", 8, "Float"), ev("send", 5),
                             ev("recv", 5), ev("barrier", 1)]}
    out = roofline.collective_bytes(trace)
    assert out == {"all-reduce": 20, "all-gather": 80, "reduce-scatter": 80,
                   "all-to-all": 32, "collective-permute": 10, "total": 222,
                   "in_scan": 0}


# ---------------------------------------------------------------------------
# dryrun
# ---------------------------------------------------------------------------

SMOKE_SHAPES = [
    tconfigs.InputShape("train_4k", 24, 2, "train"),
    tconfigs.InputShape("prefill_32k", 32, 2, "prefill"),
    tconfigs.InputShape("decode_32k", 32, 3, "decode"),
    tconfigs.InputShape("long_500k", 48, 1, "decode"),
]


def _smoke(module, arch):
    return module.smoke_variant(module.get_config(arch)).scaled(
        param_dtype="bfloat16")


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "llama4-scout-17b-a16e",
                                  "xlstm-350m", "whisper-base"])
def test_dryrun_rows_at_smoke_size(arch):
    tcfg, jcfg = _smoke(tconfigs, arch), _smoke(jconfigs, arch)
    for shape in SMOKE_SHAPES:
        js = jconfigs.InputShape(shape.name, shape.seq_len,
                                 shape.global_batch, shape.kind)
        row = dryrun.run_config(tcfg, shape, roofline.HW(), arch=arch)
        ok, reason = jconfigs.shape_applicable(jcfg, js)
        if not ok:
            assert row == {"arch": arch, "shape": shape.name,
                           "mesh": "h100x1", "status": "skipped",
                           "reason": reason}
            continue
        assert row["status"] == "ok" and row["mesh"] == "h100x1"
        assert row["chips"] == 1 and row["kind"] == shape.kind
        assert row["analytic_gflops"] == janalytic.step_flops(jcfg, js) / 1e9
        assert row["analytic_gbytes"] == janalytic.step_bytes(
            jcfg, js, 1) / 1e9
        assert row["active_params"] == janalytic.active_param_count(jcfg)
        assert row["t_compute"] == janalytic.step_flops(jcfg, js) / 989e12
        assert row["counted_gflops"] > 0 and row["fits"]
        assert row["bytes_per_device"] == row["arg_gbytes"] * 1e9
        assert row["t_collective"] == 0.0
        json.dumps(row)


@pytest.mark.parametrize("arch,layers,kind", [
    ("xlstm-350m", 4, "train"), ("jamba-1.5-large-398b", 16, "prefill"),
    ("gemma2-9b", 4, "train"), ("llama4-maverick-400b-a17b", 8, "prefill")])
def test_dryrun_extrapolation_is_exact(arch, layers, kind):
    # the cut counts (one and two layer periods, SSM loops at one and two
    # steps) extrapolate to the count of the whole step, uncut
    cfg = tconfigs.smoke_variant(tconfigs.get_config(arch)).scaled(
        param_dtype="bfloat16", num_layers=layers)
    shape = tconfigs.InputShape("s", 8, 2, kind)
    counted, _, note = dryrun.count_step(cfg, shape)
    whole = dryrun._count(dryrun._step(cfg, shape, 1, "dpsvrg")[0])
    assert counted == whole
    assert "extrapolated linearly" in note


def test_counted_flops_of_a_dense_prefill_against_analytic():
    # the plain path computes every causal score and masks half of them,
    # where the analytic model counts the average context S/2; the prefill
    # computes the lm head at each row's last position only, where the
    # analytic model counts it at every token.  So counted - analytic is
    # exactly the masked half of the scores less the head's other rows.
    cfg = _smoke(tconfigs, "minicpm-2b")          # no window, no chunk
    assert cfg.sliding_window is None and cfg.chunk is None
    for seq, batch in ((64, 2), (128, 1)):
        shape = tconfigs.InputShape("p", seq, batch, "prefill")
        counted, _, _ = dryrun.count_step(cfg, shape)
        afl = analytic.step_flops(cfg, shape)
        tokens = seq * batch
        masked_half = cfg.num_layers * 2 * tokens * cfg.num_heads * cfg.hd \
            * (seq / 2) * 2
        head_rest = 2 * (tokens - batch) * cfg.d_model * cfg.vocab_size
        assert counted == afl + masked_half - head_rest
    # at (64, 2): 0.8825 of the analytic count
    shape = tconfigs.InputShape("p", 64, 2, "prefill")
    assert math.isclose(dryrun.count_step(cfg, shape)[0]
                        / analytic.step_flops(cfg, shape), 0.8825)


# each of the reference's pod-mesh flags, and the variant it spells
POD_FLAGS = [
    (["--mesh", "single"], "baseline"), (["--mesh", "multi"], "baseline"),
    (["--mesh", "both"], "baseline"),
    (["--mesh", "multi", "--mapping", "production"], "baseline"),
    (["--gossip", "banded"], "banded"),
    (["--serve-attn-dim0"], "attn_dim0"), (["--pin-serve-outputs"], "pinned"),
    (["--moe-groups", "2"], "moe_g2"), (["--constrain-attn"], "attn_cons")]


@pytest.mark.parametrize("flags", [f for f, _ in POD_FLAGS])
def test_dryrun_refuses_the_pod_meshes_by_item(flags):
    """The reference's pod meshes and flags run on meta tensors: one row
    per shape and mesh, each on the mesh's chips, m its plan's node count,
    the reference's variant spelling, and bytes a rank from the specs that
    fit the card."""
    variant = dict((tuple(f), v) for f, v in POD_FLAGS)[tuple(flags)]
    argv = ["--arch", "h2o-danube-1.8b"] + flags
    if "--mesh" not in flags:
        argv += ["--mesh", "both"]
    rows = dryrun.main(argv)
    meshes = {"single": ["single"], "multi": ["multi"]}.get(
        argv[argv.index("--mesh") + 1], ["single", "multi"])
    assert [r["mesh"] for r in rows] == [
        mesh for _ in tconfigs.INPUT_SHAPES for mesh in meshes]
    for row in rows:
        if row["status"] == "skipped":
            continue
        assert row["status"] == "ok"
        multi = row["mesh"] == "multi"
        assert row["chips"] == (512 if multi else 256)
        mapping = "production" if "production" in flags else "auto"
        plan = jmesh.default_plan(multi, mapping)
        fake = types.SimpleNamespace(shape=tmesh.make_production_mesh(
            multi_pod=multi).shape)
        if row["kind"] == "train":
            assert row["nodes"] == jmesh.node_count(fake, plan)
        kind_variant = {"banded": "train", "attn_dim0": "decode",
                        "pinned": "prefill decode"}.get(variant)
        want = variant if kind_variant is None or \
            row["kind"] in kind_variant else "baseline"
        assert row["variant"] == want
        assert 0 < row["bytes_per_rank"] and row["fits"] == (
            row["bytes_per_rank"] <= dryrun.CARD_BYTES)


def _jax_shard_bytes(tree, specs, sizes) -> float:
    """The largest device's bytes of the reference's ``tree`` under its
    ``PartitionSpec``s (each dim over the product of its axes' sizes)."""
    total = 0.0
    for leaf, spec in zip(jax.tree.leaves(tree), jax.tree.leaves(
            specs, is_leaf=lambda s: isinstance(s, P))):
        n = 1
        for dim, entry in zip(leaf.shape, tuple(spec) + (None,) * (
                len(leaf.shape) - len(spec))):
            axes = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            n *= -(-dim // math.prod(sizes[a] for a in axes))
        total += n * np.dtype(leaf.dtype).itemsize
    return total


def _jax_dry_bytes(arch, shape, multi, mapping, attn_dim0) -> tuple:
    """(bytes_per_device, bytes a rank) of the reference's dry-run
    arguments at ``shape``, from ``jax.eval_shape`` trees and its
    ``param_specs`` / ``batch_spec`` / ``cache_specs``."""
    cfg = jconfigs.smoke_variant(jconfigs.get_config(arch)).scaled(
        param_dtype="bfloat16")
    sizes = tmesh.make_production_mesh(multi_pod=multi).shape
    chips = math.prod(sizes.values())
    plan = jmesh.default_plan(multi, mapping)
    sds = jax.ShapeDtypeStruct
    b = shape.global_batch
    if shape.kind == "train":
        m = jmesh.node_count(types.SimpleNamespace(shape=sizes), plan)
        bundle = jsteps.build_train_step(cfg, jprox.l1(1e-5), m,
                                         donate=False)
        state = jax.eval_shape(bundle.init_state, jax.random.PRNGKey(0))
        per = max(b // m, 1)
        batch = {"tokens": sds((m, per, shape.seq_len), jnp.int32),
                 "labels": sds((m, per, shape.seq_len), jnp.int32)}
        pspecs = jsharding.param_specs(state.params, plan, stacked=True,
                                       axis_sizes=sizes)
        bspecs = jax.tree.map(lambda x: jsharding.batch_spec(
            plan, x.ndim, shape=x.shape, axis_sizes=sizes), batch)
        args = (state, batch)
        rank = 3 * _jax_shard_bytes(state.params, pspecs, sizes) + 4 + \
            _jax_shard_bytes(batch, bspecs, sizes)
    else:
        params = jax.eval_shape(lambda k: jtransformer.init_params(cfg, k),
                                jax.random.PRNGKey(0))
        data = "data" if b % sizes["data"] == 0 else None
        rank = _jax_shard_bytes(params, jsharding.param_specs(
            params, plan, axis_sizes=sizes,
            attn_dim0=attn_dim0 and shape.kind == "decode"), sizes)
        if shape.kind == "prefill":
            ins = {"tokens": sds((b, shape.seq_len), jnp.int32)}
            rank += _jax_shard_bytes(ins, {"tokens": P(data, None)}, sizes)
        else:
            cache = jax.eval_shape(lambda: jtransformer.init_cache(
                cfg, b, shape.seq_len, jnp.bfloat16))
            ins = {"token": sds((b,), jnp.int32), "cache": cache}
            rank += _jax_shard_bytes(cache, jsharding.cache_specs(
                cache, plan, axis_sizes=sizes), sizes)
            rank += _jax_shard_bytes(ins["token"], P(data), sizes)
        args = (params, ins)
    total = sum(math.prod(x.shape) * np.dtype(x.dtype).itemsize
                for x in jax.tree.leaves(args))
    return total / chips, rank


DRY_SHAPES = [tconfigs.InputShape("t", 16, 32, "train"),
              tconfigs.InputShape("p", 16, 32, "prefill"),
              tconfigs.InputShape("d", 16, 32, "decode")]


@pytest.mark.parametrize("mapping", ["auto", "faithful"])
@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "llama4-scout-17b-a16e",
                                  "jamba-1.5-large-398b", "xlstm-350m"])
def test_dryrun_bytes_a_rank_are_the_references_specs(arch, multi, mapping):
    """At smoke size on both pod meshes, ``bytes_per_device`` is the
    reference's even split and ``bytes_per_rank`` the sum of the shard
    bytes its specs give, with and without ``attn_dim0``."""
    cfg = tconfigs.smoke_variant(tconfigs.get_config(arch)).scaled(
        param_dtype="bfloat16")
    mesh = "multi" if multi else "single"
    for shape in DRY_SHAPES:
        for attn_dim0 in (False, True):
            row = dryrun.run_config(cfg, shape, roofline.HW(), arch=arch,
                                    mesh=mesh, mapping=mapping,
                                    serve_attn_dim0=attn_dim0)
            per_device, per_rank = _jax_dry_bytes(arch, shape, multi,
                                                  mapping, attn_dim0)
            assert math.isclose(row["bytes_per_device"], per_device,
                                rel_tol=1e-12)
            assert row["bytes_per_rank"] == per_rank


def test_dryrun_main_writes_rows_and_make_table_renders_them(tmp_path,
                                                             capsys):
    out = tmp_path / "dry.json"
    rows = dryrun.main(["--arch", "whisper-base", "--out", str(out)])
    printed = capsys.readouterr().out
    assert "DRY-RUN SUMMARY: 3 ok, 1 skipped (documented), 0 errors over 4 " \
        "combos" in printed
    assert json.loads(out.read_text()) == json.loads(json.dumps(rows))
    table = make_table.render(make_table.load_rows([str(out)]))
    lines = table.splitlines()
    assert lines[2].endswith("| mem GB/dev (args) | build s |")
    body = [ln for ln in lines if ln.startswith("| whisper-base |")]
    assert len(body) == 3
    assert all("| h100x1 |" in ln and ("**compute**" in ln or
                                       "**memory**" in ln) for ln in body)
    assert "3 counted, 1 documented skips, 0 errors." in table
    assert "- whisper-base x long_500k (h100x1): skipped: pure " \
        "full-attention" in table
    make_table.main([str(out)])
    assert capsys.readouterr().out.strip() == table


# ---------------------------------------------------------------------------
# inspect_trace
# ---------------------------------------------------------------------------

def test_inspect_trace_on_a_cpu_prefill(tmp_path, capsys):
    cfg = tconfigs.smoke_variant(tconfigs.get_config("h2o-danube-1.8b"))
    params = transformer.init_params(cfg, 0, "cpu")
    toks = torch.as_tensor(np.arange(16, dtype=np.int32))[None]
    transformer.prefill(cfg, params, toks)
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        with record_function("serve.prefill"):
            with record_function("inner"):
                transformer.prefill(cfg, params, toks)
            torch.ones(4) + 1
    path = tmp_path / "prefill.json"
    prof.export_chrome_trace(str(path))
    res = inspect_trace.main([str(path), "--top", "5"])
    printed = capsys.readouterr().out
    assert res["source"] == "cpu ops"            # no device in this trace
    assert len(res["kernels"]) == 5 and res["all_collectives"] == []
    totals = [r["total_us"] for r in res["all_kernels"]]
    assert totals == sorted(totals, reverse=True)
    mm = [r for r in res["all_kernels"] if r["name"] == "aten::mm"]
    assert mm and {r["scope"] for r in mm} == {"inner"}
    assert sum(r["count"] for r in mm) > 0
    add = [r for r in res["all_kernels"] if r["name"] == "aten::add"
           and r["scope"] == "serve.prefill"]
    assert add and add[0]["count"] >= 1
    assert "[inner] aten::" in printed
