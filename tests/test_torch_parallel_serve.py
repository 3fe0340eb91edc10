"""The port's serving over a mesh (``parallel``'s serving half) on the CPU.

In this process, without a process group:

- ``serving_shard`` cuts every row-split product (self o, cross o, down,
  the head's w2) of the quantized whole tree into blocks whose int8 / int4
  levels and scales equal the whole leaf's block exactly, at tp 2 and 4
  (int4 K blocks in whole packed bytes, nibble order kept); a fused leaf
  is ``[q_r | k_r | v_r]`` / ``[gate_r | up_r]``;
- ``megakernel.TpLayers`` for every rank of a group, reduced between the
  parts in this process (``chip_smoke.run_ranks``), gives the one-process
  ``decode_stack_plain``'s h, k and v bit for bit (tp 1, 2, 4; int8 and
  int4 weights; bf16 and int8 pages; chain 1 and 5; at tp 2 the ``test``
  preset's 128-wide F is one activation tile that spans both ranks);
- W8A16 leaves cut as W8A8 ones; every rank's ``quant.rows_matmul_a16``
  against the whole W8A16 product within the order of its f32 sums;
- kernels 5 and 7's twins at a rank's heads equal the whole call's block
  of heads bit for bit;
- a trace draft reads a data-parallel rank's rows of the whole batch's
  trace;
- ``shard_slot_state`` splits a dense ``SlotState`` by JAX's leaf rules
  and refuses a paged one with "dense-cache" (it replaced the refusal
  that named part C);
- a data-parallel rank's draws are its rows of the whole batch's
  (``step_uniform(..., row0)``).

One two-rank and one four-rank gloo launch
(``tests/torch_parallel_serve_worker.py``), while JAX and the one-process
port decode the same requests here:

- greedy (``top_k=1``) ``engine.decode_tokens`` at tp 2, dp 2 x tp 2 and
  tp 4: bf16 paged B = 4, int8 ``paged_i8`` B = 4 and int4 ``paged_i8``
  B = 1 (tp only: one row does not split over dp), token-equal to the
  one-process port and to JAX's single-device ``engine.decode_tokens``
  (int8 and int4 with ``T5G_FUSED_ATTN=3``), every rank of a model group
  agreeing; at tp 2 and 4 W8A16, modes 0 and 1 and ``paged_f8`` B = 4
  (W8A16 under the near-tie clause);
- ``decode_tokens_speculative`` (k = 4) at tp 2 and 4 equal to the
  one-process port with the same draft (and to JAX where speculative
  equals sequential);
- sampled (``top_k=8``) streams at dp 2 and dp 2 x tp 2, and speculative
  ones at dp 2, bit-equal to the one-process port's;
- continuous batching with JAX's request recipe (dense cache, sampled): dp 2
  over ``shard_slot_state`` and tp 2, every stream equal to the
  one-process port's;
- the int8 and int4 decode stacks over the real group bit-equal to the
  one-process plain stack;
- the captured step (ROADMAP Queue 1 item 15 part D) raises at tp 2,
  naming it.

Each launch has a 300 s limit that kills its ranks, and every process
group a 120 s timeout, so a rank that misses a collective fails the test.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t5gemma_tts_tpu.config import DecodeConfig as JDecodeConfig
from t5gemma_tts_tpu.config import backbone_preset as jpreset
from t5gemma_tts_tpu.config import tiny_voice_config as jtiny
from t5gemma_tts_tpu.decode import engine as jeng
from t5gemma_tts_tpu.models import t5gemma as jt5
from t5gemma_tts_tpu.models import voice as jvoice
from t5gemma_tts_tpu.ops import quant as jquant
from t5gemma_tts_tpu_torch import bridge, parallel
from t5gemma_tts_tpu_torch import config as tconfig
from t5gemma_tts_tpu_torch.decode import continuous
from t5gemma_tts_tpu_torch.decode import engine as teng
from t5gemma_tts_tpu_torch.decode import speculative as tspec
from t5gemma_tts_tpu_torch.models import t5gemma as tt5
from t5gemma_tts_tpu_torch.ops import fused_attn as fa
from t5gemma_tts_tpu_torch.ops import megakernel as mk
from t5gemma_tts_tpu_torch.ops import paged_attn as pa
from t5gemma_tts_tpu_torch.ops import quant as tquant
from t5gemma_tts_tpu_torch.ops import sampling
from t5gemma_tts_tpu_torch.parallel import tensor as tp
from t5gemma_tts_tpu_torch.parallel.mesh import _take_rows

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402
from torch_parallel_serve_worker import (  # noqa: E402
    DECODES, FOUR, MAX_FRAMES, REFUSALS, SAMPLED, SPEC_K, SPECS, TWO,
    decode_config, drafted_trace)

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
LAUNCH_TIMEOUT = 300
CASCADE_REL = 5e-2   # the most a flipped bf16 rounding's cascade reaches


def _cfg(preset, tiny, **kw):
    bb = preset("test")
    dims = dataclasses.replace(bb.decoder, sliding_window=512)
    bb = dataclasses.replace(bb, encoder=dims, decoder=dims)
    return tiny(backbone=bb, **kw)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _requests():
    """Four rows (x, x_lens, prompt, prompt_lens, targets), numpy-seeded."""
    rng = np.random.default_rng(5)
    b = 4
    x = rng.integers(3, 500, (b, 32)).astype(np.int32)
    x_lens = np.asarray([4, 19, 32, 11], np.int32)
    prompt = np.full((b, 64), 0, np.int32)
    plens = np.asarray([0, 12, 30, 7], np.int32)
    for i, n in enumerate(plens):
        prompt[i, :n] = rng.integers(0, 128, n)
    targets = plens + np.asarray([8, 20, 14, 10], np.int32)
    return x, x_lens, prompt, plens, targets


def _continuous_requests(cfg, n, tx, pmax, seed0):
    """JAX ``tests/test_parallel.py::_continuous_requests``, the port's
    seeds: (x, x_len, prompt, prompt_len, target, seed) each."""
    reqs = []
    for s in range(n):
        rng = np.random.default_rng(seed0 + s)
        x = np.zeros((tx,), np.int32)
        xl = int(rng.integers(4, tx + 1))
        x[:xl] = rng.integers(3, cfg.text_vocab_size, xl)
        p = np.zeros((pmax,), np.int32)
        pl = int(rng.integers(0, pmax + 1))
        p[:pl] = rng.integers(0, cfg.audio_vocab_size, pl)
        tgt = pl + int(rng.integers(10, 20))
        reqs.append((x, xl, p, pl, tgt, 7000 + s))
    return reqs


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(group: str, world: int, outdir: str):
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=ROOT)
        env.pop("PYTHONSTARTUP", None)
        env.pop("T5G_FUSED_ATTN", None)
        log = open(os.path.join(outdir, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.join(HERE,
                                          "torch_parallel_serve_worker.py"),
             group, outdir], env=env, stdout=log, stderr=subprocess.STDOUT,
            cwd=ROOT), log))
    return procs


def wait(procs, outdir: str) -> None:
    try:
        for p, _ in procs:
            p.wait(timeout=LAUNCH_TIMEOUT)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    bad = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
    if bad:
        with open(os.path.join(outdir, f"rank{bad[0]}.log")) as f:
            pytest.fail(f"rank {bad[0]} exited {procs[bad[0]][0].returncode}"
                        f":\n{f.read()[-4000:]}")


def _jax_decode(qparams, jcfg, kv, inputs):
    os.environ["T5G_FUSED_ATTN"] = "3"
    os.environ["T5G_MK_STACKED"] = "0"
    try:
        out = jeng.decode_tokens(
            qparams, jcfg, JDecodeConfig(top_k=1, kv_cache=kv,
                                         max_frames=MAX_FRAMES),
            *(jnp.asarray(a) for a in inputs), jax.random.PRNGKey(0))
    finally:
        os.environ.pop("T5G_FUSED_ATTN", None)
        os.environ.pop("T5G_MK_STACKED", None)
    return np.asarray(out.tokens), np.asarray(out.gen_lens)


def _port_decode(params, cfg, kv, inputs, sampled=False, mode="3",
                 record=False):
    """The one-process port's eager decode (``record``: with each sampled
    step's logits and tokens, ``chip_smoke._recorded``)."""
    dcfg = tconfig.DecodeConfig(
        kv_cache=kv, max_frames=MAX_FRAMES,
        **(SAMPLED if sampled else dict(top_k=1)))
    logits, tokens = {}, {}
    os.environ["T5G_FUSED_ATTN"] = mode
    try:
        out = chip_smoke._recorded(lambda: teng.decode_tokens(
            params, cfg, dcfg, *(torch.from_numpy(a) for a in inputs),
            seed=7), logits, tokens)
    finally:
        os.environ.pop("T5G_FUSED_ATTN", None)
    if record:
        return out.tokens.numpy(), out.gen_lens.numpy(), logits, tokens
    return out.tokens.numpy(), out.gen_lens.numpy()


def _port_speculative(params, cfg, kind, inputs, base_tokens, mtp):
    """The one-process port's speculative decode of case ``kind``
    (``worker.SPECS``), drafted as the worker drafts it: from
    ``base_tokens`` (its sequential case's tokens) or by ``mtp``."""
    base, kv, draft = SPECS[kind]
    draft_fn = (tspec.mtp_draft_fn(mtp) if draft == "mtp" else
                tspec.trace_draft_fn(drafted_trace(
                    torch.from_numpy(base_tokens), cfg.audio_vocab_size),
                    SPEC_K))
    out = tspec.decode_tokens_speculative(
        params, cfg, decode_config(base, kv),
        *(torch.from_numpy(a) for a in inputs), seed=7, draft_fn=draft_fn,
        k=SPEC_K)
    return out.tokens.numpy(), out.gen_lens.numpy()


def _port_continuous(params, cfg, reqs, dp: bool):
    """The worker's continuous recipe in one process, unsharded."""
    dcfg = tconfig.DecodeConfig(max_frames=32, kv_cache="dense", **SAMPLED)
    fns = continuous.make_fns(cfg, dcfg, graphed=False)
    state = continuous.init_slots(cfg, dcfg, 8 if dp else 4, 10, 4,
                                  device="cpu")
    plan = [(0, 0, 5), (3, 1, 4), (6, 2, 0)] if dp else [(1, 0, 6),
                                                       (2, 1, 0)]
    for slot, i, steps in plan:
        state = fns.admit(params, state, slot, *reqs[i])
        if steps:
            state = fns.segment(params, state, steps)
    got = {}
    for _ in range(12):
        state = fns.segment(params, state, 16)
        state, outs = continuous.harvest(state)
        got.update(dict(outs))
        if not bool(state.active.any()):
            break
    return got


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Both launches at once; meanwhile JAX's and the one-process port's
    decodes of the same requests here."""
    out = {g: str(tmp_path_factory.mktemp(g)) for g in ("two", "four")}
    jcfg = _cfg(jpreset, jtiny, extra_cutoff=0.3)
    tcfg = _cfg(tconfig.backbone_preset, tconfig.tiny_voice_config,
                extra_cutoff=0.3)
    ccfg = _cfg(tconfig.backbone_preset, tconfig.tiny_voice_config,
                extra_cutoff=0.0)
    jp = {s: jvoice.init_params(jax.random.PRNGKey(s), jcfg) for s in (1, 3)}
    tp_whole = {s: bridge.params_from_jax(_np(p), "cpu")
                for s, p in jp.items()}
    reqs = _requests()
    cont = {"cont_dp": _continuous_requests(ccfg, 3, 10, 4, 100),
            "cont_tp": _continuous_requests(ccfg, 2, 10, 4, 300)}
    b1 = tuple(a[1:2] for a in reqs)
    mtp = tspec.init_mtp_heads(torch.Generator().manual_seed(11), tcfg,
                               SPEC_K)
    data = dict(cfg=tcfg, cont_cfg=ccfg, p1=tp_whole[1], p3=tp_whole[3],
                inputs=reqs, inputs1=b1, mtp=mtp, **cont)
    for d in out.values():
        torch.save(data, os.path.join(d, "inputs.pt"))
    procs = {d: launch(g, {"two": 2, "four": 4}[g], d)
             for g, d in out.items()}
    want = {}
    try:
        jq = {bits: jquant.quantize_params_for_decode(
                  jt5.fuse_for_decode(jp[3 if bits == 8 else 1]),
                  streaming_tiled=True, weight_bits=bits)
              for bits in (8, 4)}
        want["jax"] = {
            "bf16": _jax_decode(jp[3], jcfg, "paged", reqs),
            "int8": _jax_decode(jq[8], jcfg, "paged_i8", reqs),
            "int4": _jax_decode(jq[4], jcfg, "paged_i8", b1),
            "f8": _jax_decode(jp[3], jcfg, "paged_f8", reqs)}
        quantized = {bits: tquant.quantize_params_for_decode(
                         tt5.fuse_for_decode(tp_whole[3 if bits == 8 else 1]),
                         weight_bits=bits) for bits in (8, 4)}
        trees = {"f32": tp_whole[3], "int8": quantized[8],
                 "int4": quantized[4],
                 "w8a16": tquant.quantize_params_for_decode(
                     tt5.fuse_for_decode(tp_whole[3]), act_bits=16)}
        want["port"] = {
            kind: _port_decode(trees[w], tcfg, kv, b1 if b == 1 else reqs,
                               sampled, mode, record=kind == "w8a16")
            for kind, (w, kv, b, sampled, mode) in DECODES.items()}
        want["spec"] = {
            kind: _port_speculative(
                trees[DECODES[SPECS[kind][0]][0]], tcfg, kind,
                b1 if DECODES[SPECS[kind][0]][2] == 1 else reqs,
                want["port"][SPECS[kind][0]][0], mtp) for kind in SPECS}
        want["cont_dp2"] = _port_continuous(tp_whole[3], ccfg,
                                            cont["cont_dp"], dp=True)
        want["cont_tp2"] = _port_continuous(tp_whole[3], ccfg,
                                            cont["cont_tp"], dp=False)
    finally:
        for d, ps in procs.items():
            wait(ps, d)
    got = {}
    for g, d in out.items():
        world = {"two": 2, "four": 4}[g]
        for name, mesh in {"two": TWO, "four": FOUR}[g]:
            ranks = [torch.load(os.path.join(d, f"{name}.rank{r}.pt"),
                                weights_only=False) for r in range(world)]
            errors = [r["error"] for r in ranks if "error" in r]
            assert not errors, f"{name}:\n{errors[0]}"
            got[name] = dict(ranks=ranks, mesh=mesh)
    return dict(want=want, got=got)


def _assembled(case):
    """The whole batch's tokens and lengths from the ranks' rows; the
    ranks of each model group agree token for token."""
    ranks, (dp, tp_size) = case["ranks"], case["mesh"]
    b = max(r["rows"][1] for r in ranks)
    tokens = np.zeros((b, MAX_FRAMES), np.int32)
    lens = np.zeros((b,), np.int32)
    for i, r in enumerate(ranks):
        lo, hi = r["rows"]
        lead = ranks[i - i % tp_size]
        np.testing.assert_array_equal(r["tokens"].numpy(),
                                      lead["tokens"].numpy())
        tokens[lo:hi] = r["tokens"].numpy()
        lens[lo:hi] = r["gen_lens"].numpy()
    return tokens, lens


GREEDY = [(name, kind) for name, _ in TWO + FOUR
          for kind in ("bf16", "int8", "int4")
          if name.endswith("_" + kind) and not name.startswith("stack_")
          and "_spec_" not in name]


@pytest.mark.parametrize("name,kind", GREEDY)
def test_greedy_decode_over_the_mesh_equals_one_process_and_jax(
        served, name, kind):
    tokens, lens = _assembled(served["got"][name])
    port_tokens, port_lens = served["want"]["port"][kind]
    jax_tokens, jax_lens = served["want"]["jax"][kind]
    assert lens.max() < MAX_FRAMES and len(set(lens.tolist())) == len(lens)
    np.testing.assert_array_equal(lens, port_lens)
    np.testing.assert_array_equal(tokens, port_tokens)
    np.testing.assert_array_equal(lens, jax_lens)
    np.testing.assert_array_equal(tokens, jax_tokens)


MODES = [(name, name.partition("_")[2]) for name, _ in TWO + FOUR
         if name.partition("_")[2] in ("w8a16", "mode0", "mode1", "f8")]


@pytest.mark.parametrize("name,kind", MODES)
def test_greedy_modes_over_the_mesh_equal_one_process_and_jax(served, name,
                                                              kind):
    """W8A16, attention modes 0 and 1 (kernels 5 and 7's twins) and float8
    pages at tp 2 and tp 4, greedy B = 4: token-equal to the one-process
    port; modes 0 and 1 also to JAX's bf16 paged decode, float8 pages to
    JAX's paged_f8 decode. W8A16 rounds each product's f32 input to bf16
    and a rank sums its row block's f32 partials in another order, so an
    activation next to a bf16 midpoint may round apart: a row may part
    from the one-process port only at a near-tie
    (``chip_smoke.near_tie_parting``, CASCADE_REL before it)."""
    tokens, lens = _assembled(served["got"][name])
    if kind == "w8a16":
        port_tokens, port_lens, port_logits, port_sampled = \
            served["want"]["port"][kind]
        rank0 = served["got"][name]["ranks"][0]
        for r in range(len(lens)):
            n = max(lens[r], port_lens[r])
            if (lens[r] != port_lens[r]
                    or not np.array_equal(tokens[r, :n], port_tokens[r, :n])):
                chip_smoke.near_tie_parting(r, port_logits, rank0["logits"],
                                            port_sampled, rank0["sampled"],
                                            CASCADE_REL)
        return
    port_tokens, port_lens = served["want"]["port"][kind]
    assert lens.max() < MAX_FRAMES
    np.testing.assert_array_equal(lens, port_lens)
    np.testing.assert_array_equal(tokens, port_tokens)
    jax_tokens, jax_lens = served["want"]["jax"][
        "f8" if kind == "f8" else "bf16"]
    np.testing.assert_array_equal(lens, jax_lens)
    np.testing.assert_array_equal(tokens, jax_tokens)


SPEC_CASES = [name for name, _ in TWO + FOUR if "_spec_" in name
              and name.partition("_")[2] != "spec_sampled"]
# the JAX sequential decode a speculative case equals, where the file makes
# one: f32 over float8 pages (the unfused verify pass, which rounds as the
# sequential step does) and int8 over int8 pages. int4 over int8 pages
# parts from it at a near-tie: the verify pass folds the chain's keys in
# after the pages, the sequential step inside them, and an f32 difference
# that moves an int8 activation level shows in the int4 model's logits.
SPEC_JAX = {"spec_int8_i8": "int8", "spec_f8": "f8"}


@pytest.mark.parametrize("name", SPEC_CASES)
def test_speculative_over_the_mesh_equals_one_process_and_jax(served, name):
    """``decode_tokens_speculative`` at tp 2 / tp 4 (k = 4; int4 and int8
    weights over int8 and bf16 pages through kernel 2's parts at chain 5,
    f32 over float8 pages through kernel 5's twin and the chain merge;
    drafted from a trace at 90 % acceptance or by MTP heads): token-equal
    to the one-process port's speculative decode with the same draft, and
    to JAX's greedy sequential decode where the file makes one; every rank
    of the group takes the same passes, and a trace's drafts are
    accepted (fewer passes than steps)."""
    kind = name.split("_", 1)[1]
    tokens, lens = _assembled(served["got"][name])
    port_tokens, port_lens = served["want"]["spec"][kind]
    np.testing.assert_array_equal(lens, port_lens)
    np.testing.assert_array_equal(tokens, port_tokens)
    ranks = served["got"][name]["ranks"]
    assert len({(r["steps"], r["passes"]) for r in ranks}) == 1
    if SPECS[kind][2] == "trace":
        assert ranks[0]["passes"] < ranks[0]["steps"]
    if kind in SPEC_JAX:
        jax_tokens, jax_lens = served["want"]["jax"][SPEC_JAX[kind]]
        np.testing.assert_array_equal(lens, jax_lens)
        np.testing.assert_array_equal(tokens, jax_tokens)


def test_sampled_data_parallel_speculative_streams_are_bit_equal(served):
    """dp 2, sampled (top-k 8), speculative k = 4 drafted from the whole
    batch's trace (each rank drafting from its own rows of it): every
    stream bit-equal to the one-process speculative run, which needs each
    rank to draw its own rows of ``step_uniform`` (``tensor.first_row``)."""
    tokens, lens = _assembled(served["got"]["dp2_spec_sampled"])
    port_tokens, port_lens = served["want"]["spec"]["spec_sampled"]
    np.testing.assert_array_equal(lens, port_lens)
    np.testing.assert_array_equal(tokens, port_tokens)
    assert all(r["passes"] < r["steps"]
               for r in served["got"]["dp2_spec_sampled"]["ranks"])


@pytest.mark.parametrize("name", ["dp2_sampled", "dp2tp2_sampled"])
def test_sampled_data_parallel_streams_are_bit_equal(served, name):
    tokens, lens = _assembled(served["got"][name])
    port_tokens, port_lens = served["want"]["port"]["sampled"]
    np.testing.assert_array_equal(lens, port_lens)
    np.testing.assert_array_equal(tokens, port_tokens)


@pytest.mark.parametrize("name", ["cont_dp2", "cont_tp2"])
def test_continuous_streams_over_the_mesh_equal_one_process(served, name):
    case = served["got"][name]
    want = served["want"][name]
    merged = {}
    tp_size = case["mesh"][1]
    for i, r in enumerate(case["ranks"]):
        lead = case["ranks"][i - i % tp_size]["streams"]
        assert set(r["streams"]) == set(lead)
        for slot, toks in r["streams"].items():
            np.testing.assert_array_equal(toks.numpy(), lead[slot].numpy())
            merged[slot] = toks.numpy()
    assert set(merged) == set(want) and len(want) == (3 if "dp" in name
                                                      else 2)
    for slot in want:
        np.testing.assert_array_equal(merged[slot], want[slot])


@pytest.mark.parametrize("name", ["stack_tp2_int8", "stack_tp2_int4"])
def test_decode_stack_over_the_group_equals_the_plain_stack(served, name):
    for r in served["got"][name]["ranks"]:
        assert r["h_equal"] and r["k_equal"] and r["v_equal"], r


@pytest.mark.parametrize("path", REFUSALS)
def test_part_d_paths_raise_at_tp2(served, path):
    """The captured step, the one path that still refuses at tp > 1."""
    for r in served["got"]["refusals"]["ranks"]:
        msg = r["raised"][path]
        assert msg is not None and "Queue 1 item 15 part D" in msg, msg


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------

ROW_SPLIT = [("decoder", "layers", "self_attn", "o"),
             ("decoder", "layers", "cross_attn", "o"),
             ("decoder", "layers", "mlp", "down"), ("head", "w2")]


@pytest.fixture(scope="module")
def whole_trees():
    cfg = _cfg(tconfig.backbone_preset, tconfig.tiny_voice_config)
    p = tt5.fuse_for_decode(bridge.params_from_jax(
        _np(jvoice.init_params(jax.random.PRNGKey(3), _cfg(jpreset, jtiny))),
        "cpu"))
    q = {bits: tquant.quantize_params_for_decode(p, weight_bits=bits)
         for bits in (8, 4)}
    q[16] = tquant.quantize_params_for_decode(p, act_bits=16)
    return cfg, p, q


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("bits", [8, 4, 16])
@pytest.mark.parametrize("t", [2, 4])
def test_row_split_levels_and_scales_are_the_whole_blocks(whole_trees, bits,
                                                          t):
    """bits 16: W8A16 leaves (int8 levels, ``act_bits=16``), cut as W8A8
    leaves are."""
    cfg, p, q = whole_trees
    for r in range(t):
        mesh = parallel.Mesh(dp=1, tp=t, rank=r)
        shard = parallel.serving_shard(
            p, cfg, mesh, quantize=True, weight_bits=4 if bits == 4 else 8,
            act_bits=16 if bits == 16 else 8)
        for path in ROW_SPLIT:
            w, whole = _at(shard, path), _at(q[bits], path)
            if path[-1] == "o" and cfg.backbone.decoder.num_kv_heads % t:
                assert tquant.weight_levels(w).shape == \
                    tquant.weight_levels(whole).shape      # whole heads
                continue
            levels = tquant.weight_levels(whole)
            k = levels.shape[-1] // t
            assert torch.equal(tquant.weight_levels(w),
                               levels[..., r * k:(r + 1) * k]), path
            assert torch.equal(w.scale, whole.scale), path
            assert type(w) is type(whole)
            if bits == 16:
                assert w.act_bits == whole.act_bits == 16
        # a rank's fused leaves are its own columns of each part
        qkv, full = (_at(shard, ("decoder", "layers", "self_attn", "qkv")),
                     _at(q[bits], ("decoder", "layers", "self_attn", "qkv")))
        gu, gu_full = (_at(shard, ("decoder", "layers", "mlp", "gate_up")),
                       _at(q[bits], ("decoder", "layers", "mlp", "gate_up")))
        whole_f = cfg.backbone.decoder.intermediate_size
        f = whole_f // t
        cols = torch.cat([torch.arange(r * f, (r + 1) * f),
                          torch.arange(r * f, (r + 1) * f) + whole_f])
        assert torch.equal(tquant.weight_levels(gu),
                           tquant.weight_levels(gu_full)[:, cols])
        assert torch.equal(gu.scale, gu_full.scale[:, cols])
        if cfg.backbone.decoder.num_kv_heads % t == 0:
            assert qkv.n == full.n // t


def _layer_case(int4, kv_quant, chain=1):
    """Tiny decode-layer inputs: B = 4 cache rows (int4: 1), each ``chain``
    pseudo-rows (a verify pass at k = chain - 1), ``chain`` in the args."""
    cfg = tconfig.tiny_voice_config()
    dims = cfg.backbone.decoder
    layers = chip_smoke.random_quant_layers(dims, dims.num_layers, "cpu", 0,
                                            int4=int4)
    b = 1 if int4 else 4

    def rows(v):
        return np.repeat(np.asarray(v[:b]), chain).tolist()

    args = chip_smoke.decode_layer_inputs(
        dims, b * chain, kv_quant, 5, rows([3, 0, 7, 1]),
        rows([9, 4, 12, 30]), 128, "cpu", 1, chain=chain)
    return cfg, dims, layers, dict(args, chain=chain)


@pytest.mark.parametrize("chain", [1, 5])
@pytest.mark.parametrize("t", [1, 2, 4])
@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("kv_quant", [False, True])
def test_layer_parts_of_every_rank_equal_the_plain_stack(t, int4, kv_quant,
                                                         chain):
    cfg, dims, layers, args = _layer_case(int4, kv_quant, chain)
    want = mk.decode_stack_plain(layers, dims, **args)
    ranks = chip_smoke.tp_layer_ranks(layers, dims, cfg, args, t)
    chip_smoke.run_ranks([r for r, _ in ranks])
    for rank, lo in ranks:
        h, k, v = rank.outputs()
        hkv = k.shape[2]
        assert torch.equal(h, want[0])
        assert torch.equal(k, want[1][:, :, lo:lo + hkv])
        assert torch.equal(v, want[2][:, :, lo:lo + hkv])


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("int4", [False, True])
def test_row_split_products_of_every_rank_equal_the_plain_product(t, int4):
    g = torch.Generator().manual_seed(7)
    x = torch.randn((3, 256), generator=g)
    w = (torch.randn((256, 40), generator=g) * 0.02).to(torch.bfloat16)
    qw = tquant.quantize_weight_int4_lanes(w) if int4 else \
        tquant.quantize_weight(w)
    want = (tquant.w4a8_matmul_plain if int4 else tquant.w8a8_matmul_plain)(
        x, qw)
    kr = 256 // t
    xs = [x[:, r * kr:(r + 1) * kr] for r in range(t)]
    ws = [_take_rows(qw, r * kr, kr) for r in range(t)]
    got, amax, _ = chip_smoke.rows_over_group(xs, ws)
    assert torch.equal(amax, x.abs().amax(dim=-1))
    for r in got:
        assert torch.equal(r, want)


W8A16_ORDER_TOL = 1e-5   # of the product's largest magnitude: f32 sums


@pytest.mark.parametrize("t", [2, 4])
def test_w8a16_row_blocks_of_every_rank_sum_to_the_whole_product(t):
    """Every rank's ``rows_matmul_a16`` (kernel 6's twin at its K rows, an
    f32 result, the group's f32 sum, one cast) against the whole W8A16
    product: equal but for the order of the f32 sums (each rank scales its
    partial before the group adds them), within W8A16_ORDER_TOL of the
    product's largest magnitude; the ranks' results bit-equal."""
    g = torch.Generator().manual_seed(9)
    x = torch.randn((3, 256), generator=g)
    w = tquant.quantize_weight(
        (torch.randn((256, 40), generator=g) * 0.02).to(torch.bfloat16),
        act_bits=16)
    want = tquant.w8a16_matmul_plain(x, w, torch.float32)
    kr = 256 // t
    xs = [x[:, r * kr:(r + 1) * kr] for r in range(t)]
    ws = [_take_rows(w, r * kr, kr) for r in range(t)]
    assert all(wr.act_bits == 16 for wr in ws)
    total = sum(tquant.w8a16_matmul(xr, wr, torch.float32)
                for xr, wr in zip(xs, ws))
    got = [tquant.rows_matmul_a16(xr, wr, lambda _: total)
           for xr, wr in zip(xs, ws)]
    for r in got:
        assert r.dtype == torch.float32 and torch.equal(r, got[0])
    err = float((got[0] - want).abs().max())
    assert err <= W8A16_ORDER_TOL * float(want.abs().max()), err
    bf = tquant.rows_matmul_a16(xs[0].to(torch.bfloat16), ws[0],
                                lambda _: total)
    assert bf.dtype == torch.bfloat16 and torch.equal(
        bf, total.to(torch.bfloat16))


def _kernel5_case(s_len):
    """Kernel 5's inputs at the ``test``-like heads Hq / Hkv 8 / 4 (two
    cache rows, bf16 pages, permuted page tables), chain ``s_len``."""
    return chip_smoke.parts_case(
        np.random.default_rng(21), rows=2, s_len=s_len, h=8, hkv=4, hd=16,
        lens=[0, 200], pp=2, dtype=torch.bfloat16, layers=2, li=1,
        device="cpu", permute=True)


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("s_len", [1, 5])
def test_kernel5_twin_at_a_ranks_heads_is_its_block_of_the_whole(t, s_len):
    """``paged_flash_parts`` (chain s_len: the verify pass; chain 1: mode
    0's self segments) and ``paged_gqa_attention`` (cross attention) at a
    rank's heads equal the whole call's block of heads bit for bit: heads
    are independent, so a rank's output needs no collective."""
    args = _kernel5_case(s_len)
    whole = pa.paged_flash_parts(**args, attn_logits_soft_cap=50.0)
    cross = pa.paged_gqa_attention(
        args["q"], args["k_pages"], args["v_pages"], args["lengths"],
        page_indices=args["page_indices"], attn_logits_soft_cap=50.0,
        chain=s_len)
    h = args["q"].shape[1] // t
    for r in range(t):
        a = chip_smoke.head_block(args, t, r)
        part = pa.paged_flash_parts(**a, attn_logits_soft_cap=50.0)
        for got, want in zip(part, whole):
            assert torch.equal(got, want[:, r * h:(r + 1) * h])
        got = pa.paged_gqa_attention(
            a["q"], a["k_pages"], a["v_pages"], a["lengths"],
            page_indices=a["page_indices"], attn_logits_soft_cap=50.0,
            chain=s_len)
        assert torch.equal(got, cross[:, r * h:(r + 1) * h])


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("f8", [False, True])
def test_kernel7_twin_at_a_ranks_heads_is_its_block_of_the_whole(t, f8):
    """``fused_decode_attention`` (mode 1) at a rank's heads, bf16 and e4m3
    pages, equals the whole call's block of heads bit for bit."""
    base = chip_smoke.attention_case(
        np.random.default_rng(22), b=4, h=8, hkv=4, hd=16, quant=False,
        f8=f8, a_lens=[0, 128, 165, 256], b_lens=[7, 0, 129, 320], pp_a=2,
        pp_b=3, layers=2, li=1, include_current=True, device="cpu")
    args = chip_smoke.fused_args(base)
    whole = fa.fused_decode_attention(**args, attn_logits_soft_cap=50.0)
    h = args["q"].shape[1] // t
    for r in range(t):
        got = fa.fused_decode_attention(
            **chip_smoke.head_block(args, t, r), attn_logits_soft_cap=50.0)
        assert torch.equal(got, whole[:, r * h:(r + 1) * h])


def test_a_shard_outside_model_parallel_raises():
    cfg, dims, layers, args = _layer_case(False, False)
    shard = parallel.serving_shard({"decoder": {"layers": layers}}, cfg,
                                   parallel.Mesh(dp=1, tp=2, rank=0))
    with pytest.raises(ValueError, match="model_parallel"):
        mk.decode_stack(shard["decoder"]["layers"], dims, **args)


def _slot_state(kv_cache):
    cfg = _cfg(tconfig.backbone_preset, tconfig.tiny_voice_config)
    dcfg = tconfig.DecodeConfig(max_frames=32, kv_cache=kv_cache)
    state = continuous.init_slots(cfg, dcfg, 8, 10, 4, device="cpu")
    with torch.inference_mode():          # the state's tensors are
        for f in dataclasses.fields(state):   # inference tensors
            v = getattr(state, f.name)
            if isinstance(v, torch.Tensor) and v.ndim:
                v.copy_(torch.arange(v.numel()).reshape(v.shape).to(v.dtype))
    return state


def test_shard_slot_state_splits_dense_leaves_by_jax_rules():
    state = _slot_state("dense")
    for r in range(4):
        part = parallel.shard_slot_state(state, parallel.Mesh(dp=4, tp=1,
                                                              rank=r))
        lo, hi = 2 * r, 2 * r + 2
        assert part.slot0 == lo
        for f in dataclasses.fields(state.cache):
            assert torch.equal(getattr(part.cache, f.name),
                               getattr(state.cache, f.name)[:, lo:hi])
        for f in dataclasses.fields(state):
            v = getattr(state, f.name)
            if isinstance(v, torch.Tensor):
                assert torch.equal(getattr(part, f.name), v[lo:hi]), f.name
    with pytest.raises(ValueError, match="not divisible"):
        parallel.shard_slot_state(state, parallel.Mesh(dp=3, tp=1))


def test_shard_slot_state_refuses_a_paged_state():
    with pytest.raises(ValueError, match="dense-cache"):
        parallel.shard_slot_state(_slot_state("paged"),
                                  parallel.Mesh(dp=2, tp=1))


def test_a_trace_draft_reads_a_data_parallel_ranks_rows():
    """``trace_draft_fn`` of the whole batch's trace drafts a dp rank's
    rows from its own rows of it; a trace of the rank's rows alone is read
    as it is."""
    trace = torch.arange(4 * 12, dtype=torch.int32).reshape(4, 12)
    draft = tspec.trace_draft_fn(trace, 3)
    cur = torch.zeros((2,), dtype=torch.int32)
    for r in range(2):
        with tp.model_parallel(parallel.Mesh(dp=2, tp=1, rank=r)):
            got = draft(None, cur, 5)
            own = tspec.trace_draft_fn(trace[2 * r:2 * r + 2], 3)(None, cur,
                                                                  5)
        assert torch.equal(got, trace[2 * r:2 * r + 2, 6:9])
        assert torch.equal(own, got)


def test_a_data_parallel_ranks_draws_are_its_rows_of_the_batch():
    whole = sampling.step_uniform(11, 5, 8, 70)
    for r in range(4):
        mesh = parallel.Mesh(dp=4, tp=1, rank=r)
        with tp.model_parallel(mesh):
            row0 = tp.first_row(2)
        assert torch.equal(sampling.step_uniform(11, 5, 2, 70, row0=row0),
                           whole[2 * r:2 * r + 2])
        assert torch.equal(sampling.step_uniform(
            11, 5, 2, 70, row0=torch.tensor(row0)), whole[2 * r:2 * r + 2])
