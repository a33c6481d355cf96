"""repro_torch's dry-run (``launch/dryrun.py``), the dense LM configs it
covers, ``count_params`` and the public surface, held against repro.

The dry-run of ``probesim`` SMOKE (at 1 and 4 blocks, all-gather and
ring) and of ``llama3.2-1b`` smoke (prefill and decode) counts the same
FLOPs, bytes and collective bytes on ``meta`` as the same step on real CPU
tensors; its ``argument_gb`` is the bytes of the state built on the CPU
over the chips.  The CLI writes a record per cell, a ``__skip.json`` with
its reason for every cell the port does not have, and a ``.FAILED.json``
(exit non-zero) for a cell that fails; the report renders the records.
"""
import dataclasses
import importlib
import json
import sys
import warnings

import numpy as np
import pytest
import torch

import jax

import repro.arch as JA
import repro.configs.base as JCB
import repro.core as JC
import repro.core.probesim as JP
from repro.configs import llama3_405b as j_405b
from repro.configs import yi_34b as j_yi
from repro.models.common import count_params as j_count_params
from repro.models.transformer import model as JM

import repro_torch.arch as TA
import repro_torch.configs.base as TCB
import repro_torch.core as TC
import repro_torch.launch.dryrun as D
import repro_torch.roofline.report as RR
from repro_torch.api import GraphHandle
from repro_torch.configs import llama3_405b as t_405b
from repro_torch.configs import yi_34b as t_yi
from repro_torch.core.distributed import csr_uniforms
from repro_torch.core.params import make_params
from repro_torch.core.walks import make_generator
from repro_torch.graph import powerlaw_graph
from repro_torch.launch.mesh import ShardMesh
from repro_torch.models.common import count_params
from repro_torch.models.transformer import model as TM
from torch_port_helpers import one_thread  # noqa: F401  (a fixture)

CPU = "cpu"

# ---------------------------------------------------------------------------
# Configs, count_params, the public surface
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pair", [(j_yi, t_yi), (j_405b, t_405b)],
                         ids=["yi-34b", "llama3-405b"])
@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_dense_lm_configs_pinned_to_repro(pair, which):
    j, t = (getattr(m, which) for m in pair)
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.params_dense, t.params_active) == (j.params_dense, j.params_active)
    arch = pair[0].CONFIG.name
    assert arch in TCB._MODULE_OF  # registered: every config is ported
    assert TCB.get_config(arch, smoke=which == "SMOKE") == t
    assert t.d_head <= 128  # the flash kernel's MAX_HEAD_DIM
    assert TCB.scale_down(t, n_layers=3) == dataclasses.replace(t, n_layers=3)
    assert (dataclasses.asdict(TCB.scale_down(t, vocab=64))
            == dataclasses.asdict(JCB.scale_down(j, vocab=64)))


def test_arch_ids_and_every_familys_shapes_equal_repro():
    assert TCB.ARCH_IDS == JCB.ARCH_IDS
    for arch in JCB.ARCH_IDS:
        ours = [(s.name, s.kind, s.dims) for s in TCB.shapes_for(arch)]
        assert ours == [(s.name, s.kind, s.dims) for s in JCB.shapes_for(arch)]
        assert TCB.family_of(arch) == JCB.get_config(arch).family
        for s in JCB.shapes_for(arch):
            assert TA.is_applicable(arch, s.name) == JA.is_applicable(arch, s.name)


@pytest.mark.parametrize("cfg", [j_yi.SMOKE, j_405b.SMOKE], ids=["yi", "405b"])
def test_count_params_equals_repro(cfg):
    params = JM.init_lm(jax.random.key(0), cfg)
    tcfg = TCB.get_config(cfg.name.removesuffix("-smoke"), smoke=True)
    model = TM.lm_from_params(jax.tree_util.tree_map(np.asarray, params), tcfg,
                              device=CPU)
    assert count_params(model) == j_count_params(params)
    assert count_params(model.tree()) + sum(
        count_params(b) for b in model.stage(0)) == j_count_params(params)
    # the port's own init and its meta shapes hold as many
    assert count_params(TM.init_lm(None, tcfg)) == j_count_params(params)


# Names of repro's public surface that the port leaves out, with the reason.
LEFT_OUT = {
    "core": {"shard_epoch_specs": "jax only: sharding specs of the mesh epoch",
             "epoch_pipeline": "removed: the fused epoch step replaces it"},
    "graph": {"apply_update_batch_jit": "jax only: a jitted wrapper"},
}


def _public(mod) -> set:
    """A module's ``__all__``, or (a module without one) the public names
    it defines itself."""
    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    return {n for n, v in vars(mod).items() if not n.startswith("_")
            and getattr(v, "__module__", None) == mod.__name__}


@pytest.mark.parametrize("pkg", [
    "api", "core", "graph", "serving", "streams", "training.step",
    "training.optimizer", "training.compression", "data.synthetic", "data.pipeline",
    "checkpoint.checkpointer", "launch.train"])
def test_public_surface_covers_repros(pkg):
    theirs = _public(importlib.import_module(f"repro.{pkg}"))
    ours = importlib.import_module(f"repro_torch.{pkg}")
    assert theirs, pkg
    assert theirs - _public(ours) == set(LEFT_OUT.get(pkg, {}))
    for name in _public(ours):
        assert hasattr(ours, name), name


def test_single_source_simple_equals_repros_rules(monkeypatch):
    src, dst, n = powerlaw_graph(60, 300, seed=1)
    h = GraphHandle.from_edges(src, dst, n, device=CPU)
    params = make_params(n, eps_a=0.5)  # 251 walks
    u = int(np.bincount(dst, minlength=n).argmax())
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a handle warns nothing
        got = TC.single_source_simple(3, h, u, eps_a=0.5, walk_chunk=64)
    assert torch.equal(got, TC.single_source(3, h.g, h.eg, u, params, walk_chunk=64))
    with pytest.warns(DeprecationWarning) as rec:
        bare = TC.single_source_simple(3, h.eg, u, eps_a=0.5, walk_chunk=64)
    assert torch.equal(bare, TC.single_source(3, h.eg, h.eg, u, params, walk_chunk=64))
    # repro's words, naming the port's package (repro's probe is stubbed:
    # the warning comes first)
    from repro.graph import ell_from_edges

    monkeypatch.setattr(JP, "single_source", lambda *a, **k: None)
    with pytest.warns(DeprecationWarning) as jrec:
        JC.single_source_simple(jax.random.key(0), ell_from_edges(src, dst, n, k_max=64),
                                u)
    assert str(rec[0].message) == str(jrec[0].message).replace(
        "repro.api.GraphHandle", "repro_torch.api.GraphHandle")


# ---------------------------------------------------------------------------
# The dry-run
# ---------------------------------------------------------------------------


def _probesim(mode, s, dev):
    cfg = dataclasses.replace(TCB.get_config("probesim", smoke=True), push_mode=mode)
    shape = TA._shrink_shape(cfg, TCB.shapes_for("probesim")[0])
    return TA.build_with_cfg("probesim", cfg, shape, device=dev,
                             mesh=ShardMesh([dev] * s))


@pytest.mark.parametrize("mode", ["auto", "ring"])
@pytest.mark.parametrize("s", [1, 4])
def test_probesim_dry_run_counts_equal_the_cpu_step(mode, s, one_thread):
    real, meta = _probesim(mode, s, CPU), _probesim(mode, s, "meta")
    state, mstate = real.init(), D.abstract_state(meta)
    assert all(t.is_meta for t in mstate[0].src_sh)
    inputs = D.abstract_inputs(real, device=CPU)
    q, b = real.shape.dims["queries"], real.shape.dims["walk_chunk"]
    inputs["batch"]["queries"] = torch.tensor([1, 2], dtype=torch.int32)
    inputs["uniforms"] = csr_uniforms(
        make_generator(0, CPU), walks=q * b, sqrt_c=real.cfg.c ** 0.5, device=CPU,
        max_len=make_params(real.cfg.n).max_len)
    rep, c = D.count_step(real, state, inputs, mesh_name="cpu", chips=s)
    mrep, mc = D.count_step(meta, mstate, D.abstract_inputs(meta), mesh_name="meta",
                            chips=s)
    assert mc.totals() == c.totals()
    assert c.flops > 0 and c.bytes > 0
    kind = "all-gather" if mode == "auto" else "collective-permute"
    assert (c.collective_bytes[kind] > 0) == (s > 1)
    levels = make_params(real.cfg.n).max_len - 1
    assert c.collective_bytes[kind] == (s - 1) * state[0].n_pad * q * b * 4 * levels
    built = D.state_bytes(state) + D.state_bytes(inputs)
    assert mrep.memory_per_device["argument_gb"] == pytest.approx(built / s * 1e-9,
                                                                  rel=1e-12)
    assert rep.hlo_flops == c.flops / s and mrep.bottleneck == rep.bottleneck


def test_run_cell_on_a_real_mesh_equals_meta(one_thread):
    """``run_cell(mesh=...)``: the same cell (a real graph of SMOKE's size)
    on two CPU blocks and on two meta blocks counts the same; the CPU
    blocks share one card (chips 1), the meta blocks stand for two."""
    over = dict(n=512, m=4096, delta=0.1)
    cpu = D.run_cell("probesim", "serve_online", "cpu", overrides=over,
                     mesh=ShardMesh([CPU] * 2))
    meta = D.run_cell("probesim", "serve_online", "meta", overrides=over,
                      mesh=ShardMesh(["meta"] * 2))
    assert (cpu["chips"], meta["chips"]) == (1, 2)
    for k in ("hlo_flops", "hlo_bytes", "collective_bytes", "tensor_core_flops"):
        assert cpu[k] == meta[k] * 2
    assert cpu["overrides"] == {"n": "512", "m": "4096", "delta": "0.1"}
    assert meta["bottleneck"] in ("memory", "collective") and meta["fits_hbm"]


@pytest.mark.parametrize("chips", [1, 4])
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_lm_dry_run_counts_equal_the_cpu_step(shape, chips):
    real = TA.build("llama3.2-1b", shape, smoke=True, device=CPU)
    meta = TA.build("llama3.2-1b", shape, smoke=True, device="meta")
    state = real.init(torch.Generator().manual_seed(0))
    mstate = D.abstract_state(meta)
    rep, c = D.count_step(real, state, D.abstract_inputs(real, device=CPU),
                          mesh_name="cpu", chips=chips)
    mrep, mc = D.count_step(meta, mstate, D.abstract_inputs(meta),
                            mesh_name="meta", chips=chips)
    assert mc.totals() == c.totals()
    assert mrep.memory_per_device["argument_gb"] == pytest.approx(
        (D.state_bytes(state) + D.state_bytes(D.abstract_inputs(real, device=CPU)))
        / chips * 1e-9, rel=1e-12)
    assert rep.hlo_flops * chips == c.flops
    if shape == "prefill_32k":
        cfg = real.cfg
        B, S = real.shape.dims["global_batch"], real.shape.dims["seq_len"]
        head = cfg.d_model * cfg.vocab  # tied: the embedding is the head
        matmul = 2 * (cfg.params_dense - head) * B * S + 2 * head * B  # last token only
        flash = cfg.n_layers * B * cfg.n_heads * S * (S + 1) / 2 * 4 * cfg.d_head
        assert c.by_op["flash_attention"][1].flops == flash
        assert c.by_op["mm"][1].flops == matmul
        # the rest (norms, rope, SwiGLU's product, residuals) at this
        # smoke width adds 1-2 % of the counted FLOPs
        ratio = real.model_flops() / (matmul + flash)
        assert ratio / 1.03 < rep.useful_flops_ratio <= ratio
        assert rep.tensor_core_flops == 0  # the smoke config computes in fp32


@pytest.mark.parametrize("name", ["llama3.2-1b", "qwen2-moe-a2.7b",
                                  "deepseek-v2-lite-16b"])
def test_lm_train_dry_run_counts_equal_the_cpu_step(name):
    """The SMOKE ``train_4k`` step (forward, backward, AdamW) counts the
    same on ``meta`` as on CPU tensors, backward ops and the update
    included; remat (``cfg.remat``) adds one more forward of the blocks'
    products up to the last one whose saved tensors the backward needs
    (torch's checkpoint stops its recompute early): for Llama 2 x (the
    blocks' parameters less each block's ``w_down``) x B x S FLOPs."""
    counts = {}
    for remat in (False, True):
        cfg = dataclasses.replace(TCB.get_config(name, smoke=True), remat=remat)
        shape = TA._shrink_shape(cfg, TCB.shapes_for(name)[0])
        assert shape.name == "train_4k"
        real = TA.build_with_cfg(name, cfg, shape, device=CPU, use_kernel=False)
        meta = TA.build_with_cfg(name, cfg, shape, device="meta", use_kernel=False)
        state = real.init(torch.Generator().manual_seed(0))
        rep, c = D.count_step(real, state, D.abstract_inputs(real, device=CPU),
                              mesh_name="cpu", chips=1)
        mrep, mc = D.count_step(meta, D.abstract_state(meta), D.abstract_inputs(meta),
                                mesh_name="meta", chips=1)
        assert mc.totals() == c.totals()
        assert mrep.memory_per_device["argument_gb"] == pytest.approx(
            (D.state_bytes(state) + D.state_bytes(D.abstract_inputs(real, device=CPU)))
            * 1e-9, rel=1e-12)
        for op in ("_softmax_backward_data", "logsumexp", "sqrt"):  # bwd, loss, AdamW
            assert op in c.by_op, op
        assert 0 < rep.useful_flops_ratio < 1
        counts[remat] = (c, cfg, real.shape.dims)
    (c0, cfg, dims), (c1, _, _) = counts[False], counts[True]
    extra = c1.by_op["mm"][1].flops - c0.by_op["mm"][1].flops
    if name == "llama3.2-1b":
        head = cfg.d_model * cfg.vocab  # tied
        w_down = cfg.n_layers * cfg.d_ff * cfg.d_model
        assert extra == (2 * (cfg.params_dense - head - w_down) * dims["global_batch"]
                         * dims["seq_len"])
    else:
        assert extra > 0


def test_dry_run_cli_records_skips_failures_and_report(tmp_path, capsys):
    out = str(tmp_path)
    D.main(["--arch", "llama3.2-1b", "--shape", "prefill_32k", "--mesh", "both",
            "--out", out])
    D.main(["--arch", "llama3.2-1b", "--shape", "train_4k", "--out", out])
    for arch, shape in (("wide-deep", "train_batch"), ("gatedgcn", "full_graph_sm"),
                        ("gin-tu", "molecule"), ("llama3-405b", "long_500k")):
        D.main(["--arch", arch, "--shape", shape, "--out", out])
    with pytest.raises(SystemExit, match="1 dry-run cells failed"):
        D.main(["--arch", "llama3.2-1b", "--shape", "prefill_32k", "--set", "d_head=200",
                "--tag", "bad", "--out", out])
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == [
        "gatedgcn__full_graph_sm__single.json", "gin-tu__molecule__single.json",
        "llama3-405b__long_500k__skip.json",
        "llama3.2-1b__prefill_32k__multi.json",
        "llama3.2-1b__prefill_32k__single.json",
        "llama3.2-1b__prefill_32k__single__bad.FAILED.json",
        "llama3.2-1b__train_4k__single.json",
        "wide-deep__train_batch__single.json"]
    train = json.loads((tmp_path / "llama3.2-1b__train_4k__single.json").read_text())
    assert train["chips"] == 256 and train["model_flops"] == pytest.approx(
        6.0 * TCB.get_config("llama3.2-1b").params_active * 256 * 4096, rel=1e-12)
    # the backward and remat's recompute count: useful / counted well below 1
    assert 0.5 < train["useful_flops_ratio"] < 0.8
    skips = {n: json.loads((tmp_path / n).read_text())["skip_reason"]
             for n in names if n.endswith("__skip.json")}
    # every config is ported: the one skip is the inapplicable cell's
    assert skips == {"llama3-405b__long_500k__skip.json":
                     TA.is_applicable("llama3-405b", "long_500k")[1]}
    single = json.loads((tmp_path / "llama3.2-1b__prefill_32k__single.json").read_text())
    multi = json.loads((tmp_path / "llama3.2-1b__prefill_32k__multi.json").read_text())
    assert (single["chips"], multi["chips"]) == (256, 512)
    assert single["hlo_flops"] == pytest.approx(2 * multi["hlo_flops"], rel=1e-12)
    assert single["bottleneck"] == "compute" and single["fits_hbm"]
    assert single["tensor_core_flops"] > 0.9 * single["hlo_flops"]  # bf16 GEMMs + flash
    capsys.readouterr()
    argv, sys.argv = sys.argv, ["report", out]
    try:
        RR.main()
    finally:
        sys.argv = argv
    text = capsys.readouterr().out
    assert "| llama3.2-1b | prefill_32k | single |" in text
    assert "| wide-deep | train_batch | single |" in text
    assert "not ported" not in text
    assert "| gin-tu | molecule | single |" in text
