"""The port's SimRank -> Wide & Deep retrieval example
(``repro_torch.examples.simrank_recsys_retrieval``) at its toy size in a
subprocess on the CPU, its stages called directly, and the ``cuda`` twins
of the recsys bundles (card against CPU on the same weights, fp32: logits
and losses within 1e-5 of their largest magnitude).  No JAX here: the card
tests compare the port with itself on the CPU.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.arch as TA
from repro_torch.examples import simrank_recsys_retrieval as X
from repro_torch.launch import train as TLT
from repro_torch.models.recsys import widedeep as TW
from repro_torch.training.tree import leaves, tree_map
from torch_port_helpers import CPU, needs_cuda, one_thread, rel_close  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

SRC = Path(__file__).resolve().parent.parent / "src"


def test_example_runs_at_its_toy_size():
    """1,000 users, 300 items, 12,000 requested interactions over 2 virtual
    seconds, TTL 0.8 s: every arrival and expiry applied, retrievals
    answered, a seed item's candidates re-ranked."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.examples.simrank_recsys_retrieval",
                        "--device", "cpu"], capture_output=True, text=True, env=env,
                       timeout=1200)
    assert r.returncode == 0, r.stderr[-3000:]
    out = r.stdout
    assert "streamed 7300 interactions, expired 4416 (window=2884); 40 retrievals" in out
    assert out.count("churn checkpoint") == 2
    assert "seed item 1: retrieved 20 candidate items" in out
    assert "wide-deep re-ranked top5: [(" in out
    assert time.perf_counter() - t0 < 1200


def test_stream_leg_and_rerank_stages():
    """The stages at a smaller size: the live window's edge count and the
    handle's agree, the retrieved candidates are items of the window and
    the re-rank batch is the config's width."""
    stream, n = X.interaction_stream(200, 60, 1_600, 1.0, seed=3)
    # each kept interaction is a pair of directed edges, one timestamp each
    assert n == 260 and len(stream) % 2 == 0 and len(stream) <= 1_600
    assert (stream.src[::2] == stream.dst[1::2]).all() and (stream.t[::2] == stream.t[1::2]).all()
    sess, rep = X.serve_stream(stream, ttl=0.4, capacity=1 << 11, k_max=256, device=CPU,
                               max_ticks=6)
    assert rep.ticks == 6 and rep.queries == 12
    assert rep.updates_applied == rep.arrivals + rep.expired
    assert rep.final_live_edges == sess.handle.num_edges and not rep.sticky_overflow
    seed_item, cands, scores = X.retrieve(sess, 200)
    assert 0 <= seed_item < 60 and len(cands) == len(scores) <= 20
    assert ((cands >= 0) & (cands < 60)).all() and (np.diff(scores) <= 0).all()
    cfg = TA.build("wide-deep", "serve_p99", smoke=True, device=CPU).cfg
    batch = X.rerank_batch(cands, cfg, np.random.default_rng(0), CPU)
    assert batch["sparse_ids"].shape == (len(cands), cfg.n_sparse)
    assert (batch["sparse_ids"][:, 0].numpy() == cands).all()
    assert batch["dense"].shape == (len(cands), cfg.n_dense)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


def _host_batch(bundle, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in bundle.input_specs()["batch"].items():
        if s.dtype == torch.int32:
            hi = 2 if k == "labels" else bundle.cfg.vocab_per_field
            out[k] = torch.from_numpy(rng.integers(0, hi, s.shape).astype(np.int32))
        else:
            out[k] = torch.from_numpy(rng.normal(size=s.shape).astype(np.float32))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["train_batch", "serve_p99", "serve_bulk",
                                   "retrieval_cand"])
def test_recsys_bundles_on_the_card_equal_the_cpu(shape):
    """Each bundle at smoke size on the card from the CPU's weights: train
    (two steps: losses, then every parameter), serve logits, retrieval's
    top-100 values (ids where untied)."""
    needs_cuda()
    tb = TA.build("wide-deep", shape, smoke=True, device=CPU)
    cb = TA.build("wide-deep", shape, smoke=True, device="cuda")
    state = tb.init(torch.Generator().manual_seed(0))
    cstate = tree_map(lambda t: t.detach().to("cuda").requires_grad_(t.requires_grad), state)
    batch = _host_batch(tb, 1)
    cbatch = {k: v.cuda() for k, v in batch.items()}
    if shape == "train_batch":
        for _ in range(2):
            p, o, m = tb.step(*state, batch)
            cp, co, cm = cb.step(*cstate, cbatch)
            state, cstate = (p, o), (cp, co)
            rel_close(cm["loss"], m["loss"].numpy(), 1e-5, "loss")
        for a, w in zip(leaves(cstate[0]), leaves(state[0]), strict=True):
            rel_close(a, w.detach().numpy(), 1e-5, "parameter")
        return
    with torch.inference_mode():
        out, cout = tb.step(*state, batch), cb.step(*cstate, cbatch)
    if shape != "retrieval_cand":
        rel_close(cout, out.numpy(), 1e-5, "logits")
        return
    rel_close(cout.values, out.values.numpy(), 1e-5, "top-100 values")
    v = out.values.double().numpy()
    tol = 1e-5 * np.abs(v).max()
    gaps = np.abs(np.diff(v)) > 2 * tol
    untied = np.ones(100, bool)
    untied[:-1] &= gaps
    untied[1:] &= gaps
    np.testing.assert_array_equal(cout.indices.cpu().numpy()[untied],
                                  out.indices.numpy()[untied])


@pytest.mark.cuda
def test_recsys_restart_on_the_card(tmp_path):
    """The launcher on the card at smoke size, fail -> restart: bitwise equal
    to a clean run (deterministic mode: the embedding's backward)."""
    needs_cuda()
    kw = dict(smoke=True, steps=8, ckpt_every=3, device="cuda")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with pytest.raises(RuntimeError, match="injected failure"):
            TLT.train("wide-deep", "train_batch", ckpt_dir=str(tmp_path), fail_at=5, **kw)
        resumed = TLT.train("wide-deep", "train_batch", ckpt_dir=str(tmp_path), **kw)
        clean = TLT.train("wide-deep", "train_batch", ckpt_dir=None, **kw)
    finally:
        torch.use_deterministic_algorithms(False)
    for x, y in zip(leaves(TLT.state_tree(*resumed["state"])),
                    leaves(TLT.state_tree(*clean["state"])), strict=True):
        assert torch.equal(x, y)
    assert isinstance(TW.widedeep_to_params(resumed["state"][0])["embed"], np.ndarray)
