"""One rank of the port's gloo serving runs for
``tests/test_torch_parallel_serve.py``.

Launched once per rank with torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``):

    python tests/torch_parallel_serve_worker.py {two,four} OUTDIR

Imports only ``torch``, numpy, the port and ``chip_smoke`` (JAX-free). It
reads ``OUTDIR/inputs.pt`` (the whole one-process trees and the requests
the test wrote) and writes ``OUTDIR/<case>.rank<r>.pt`` for every case:
the rank's tokens (its rows under dp), or its continuous streams by global
slot, or its checks, with the traceback of a case that raised. Each rank
cuts its own serving shard with ``parallel.serving_shard`` (quantized
whole first) and decodes through the ordinary entry points inside
``parallel.tensor.model_parallel(mesh)``:

- ``two`` (world 2): tp 2 greedy bf16 paged B = 4, int8 ``paged_i8``
  B = 4 and int4 ``paged_i8`` B = 1, W8A16 paged B = 4, attention modes 0
  and 1 B = 4 and f32 over ``paged_f8`` B = 4; speculative (k = 4) int4
  over ``paged_i8`` and ``paged`` B = 1, int8 over ``paged_i8`` B = 4 and
  f32 over ``paged_f8`` B = 4, each drafted from its sequential case's
  trace corrupted to 90 % acceptance (:func:`drafted_trace`), and int8
  over ``paged`` B = 4 drafted by MTP heads; dp 2 sampled bf16 B = 4,
  sequential and speculative (drafted from the whole batch's sampled
  trace, which the ranks gather); continuous dp 2 over
  ``shard_slot_state`` and continuous tp 2 (the JAX tests' recipe, dense
  cache); the int8 and int4 decode stacks over the real group against the
  plain one-process stack; the two captured paths' refusals.
- ``four`` (world 4): tp 4 (the ``test`` preset's 2 kv heads do not
  divide 4: attention stays whole, the MLP and the head split) greedy
  bf16, int8, int4, W8A16, modes 0 and 1 and ``paged_f8``, speculative
  int4 over ``paged_i8`` and f32 over ``paged_f8``; dp 2 x tp 2 greedy
  bf16 and int8, and sampled.
"""

import dataclasses
import os
import sys
import traceback
from datetime import timedelta

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from t5gemma_tts_tpu_torch import parallel  # noqa: E402
from t5gemma_tts_tpu_torch.config import DecodeConfig  # noqa: E402
from t5gemma_tts_tpu_torch.decode import continuous, engine  # noqa: E402
from t5gemma_tts_tpu_torch.decode import speculative  # noqa: E402
from t5gemma_tts_tpu_torch.ops import megakernel as mk  # noqa: E402
from t5gemma_tts_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from t5gemma_tts_tpu_torch.parallel import tensor as tp  # noqa: E402

torch.set_num_threads(1)
TIMEOUT = timedelta(seconds=120)
MAX_FRAMES = 48
SAMPLED = dict(top_k=8, top_p=0.9, temperature=0.8)
SPEC_K = 4             # drafted tokens a verify pass
ACCEPT = 0.9           # a drafted trace's per-token acceptance
# decode cases: (weights, kv cache, batch rows, sampled, T5G_FUSED_ATTN)
DECODES = {"bf16": ("f32", "paged", 4, False, "3"),
           "int8": ("int8", "paged_i8", 4, False, "3"),
           "int4": ("int4", "paged_i8", 1, False, "3"),
           "sampled": ("f32", "paged", 4, True, "3"),
           "w8a16": ("w8a16", "paged", 4, False, "3"),
           "mode0": ("f32", "paged", 4, False, "0"),
           "mode1": ("f32", "paged", 4, False, "1"),
           "f8": ("f32", "paged_f8", 4, False, "3")}
# speculative cases: (the decode case whose weights, cache, rows and
# sampling they take, its kv cache, the draft: that case's trace or "mtp")
SPECS = {"spec_int4_i8": ("int4", "paged_i8", "trace"),
         "spec_int4": ("int4", "paged", "trace"),
         "spec_int8_i8": ("int8", "paged_i8", "trace"),
         "spec_f8": ("f8", "paged_f8", "trace"),
         "spec_mtp": ("int8", "paged", "mtp"),
         "spec_sampled": ("sampled", "paged", "trace")}
TWO = [("tp2_bf16", (1, 2)), ("tp2_int8", (1, 2)), ("tp2_int4", (1, 2)),
       ("tp2_w8a16", (1, 2)), ("tp2_mode0", (1, 2)), ("tp2_mode1", (1, 2)),
       ("tp2_f8", (1, 2)), ("tp2_spec_int4_i8", (1, 2)),
       ("tp2_spec_int4", (1, 2)), ("tp2_spec_int8_i8", (1, 2)),
       ("tp2_spec_f8", (1, 2)), ("tp2_spec_mtp", (1, 2)),
       ("dp2_sampled", (2, 1)), ("dp2_spec_sampled", (2, 1)),
       ("cont_dp2", (2, 1)), ("cont_tp2", (1, 2)),
       ("stack_tp2_int8", (1, 2)), ("stack_tp2_int4", (1, 2)),
       ("refusals", (1, 2))]
FOUR = [("tp4_bf16", (1, 4)), ("tp4_int8", (1, 4)), ("tp4_int4", (1, 4)),
        ("tp4_w8a16", (1, 4)), ("tp4_mode0", (1, 4)), ("tp4_mode1", (1, 4)),
        ("tp4_f8", (1, 4)), ("tp4_spec_int4_i8", (1, 4)),
        ("tp4_spec_f8", (1, 4)),
        ("dp2tp2_bf16", (2, 2)), ("dp2tp2_int8", (2, 2)),
        ("dp2tp2_sampled", (2, 2))]
# the paths that must raise at tp > 1: the captured step (a captured
# collective, shown only with more than one card)
REFUSALS = ("graphed_decoder", "continuous_capture")


def shard(data, weights: str, mesh):
    """This rank's serving tree for ``weights`` ("f32", "int8", "int4",
    "w8a16")."""
    whole = data["p1"] if weights == "int4" else data["p3"]
    return parallel.serving_shard(
        whole, data["cfg"], mesh, quantize=weights != "f32",
        weight_bits=4 if weights == "int4" else 8,
        act_bits=16 if weights == "w8a16" else 8)


def decode_config(kind: str, kv: str = None) -> DecodeConfig:
    """The DecodeConfig of decode case ``kind`` (``kv``: another cache)."""
    _, kv0, _, sampled, _ = DECODES[kind]
    return DecodeConfig(top_k=SAMPLED["top_k"] if sampled else 1,
                        kv_cache=kv or kv0, max_frames=MAX_FRAMES,
                        **({k: v for k, v in SAMPLED.items() if k != "top_k"}
                           if sampled else {}))


def drafted_trace(tokens: torch.Tensor, vocab: int) -> torch.Tensor:
    """A sequential decode's tokens [B, T] as a draft trace at ACCEPT
    per-token acceptance: each token replaced by its successor (mod
    ``vocab``) where a numpy-seeded uniform exceeds ACCEPT."""
    own = tokens.numpy()
    corrupt = np.random.default_rng(0).random(own.shape) > ACCEPT
    return torch.from_numpy(np.where(corrupt, (own + 1) % vocab, own)
                            .astype(np.int32))


def inputs(data, b: int, mesh=None):
    """The decode inputs of the batch of ``b`` rows (this rank's rows under
    dp): the four requests, or the batch-1 request."""
    x, x_lens, prompt, plens, targets = (
        torch.from_numpy(a) for a in data["inputs" if b > 1 else "inputs1"])
    if mesh is not None and mesh.dp > 1:
        lo, hi = mesh_mod.batch_rows(b, mesh)
        x, x_lens, prompt, plens, targets = (
            t[lo:hi] for t in (x, x_lens, prompt, plens, targets))
    return x, x_lens, prompt, plens, targets


def decode(data, mesh, kind: str) -> dict:
    weights, kv, b, sampled, mode = DECODES[kind]
    params = shard(data, weights, mesh)
    dcfg = decode_config(kind)
    logits, sampled_tokens = {}, {}
    os.environ["T5G_FUSED_ATTN"] = mode
    try:
        with tp.model_parallel(mesh):
            out = chip_smoke._recorded(lambda: engine.decode_tokens(
                params, data["cfg"], dcfg, *inputs(data, b, mesh), seed=7),
                logits, sampled_tokens)
    finally:
        os.environ.pop("T5G_FUSED_ATTN", None)
    rows = mesh_mod.batch_rows(b, mesh) if mesh.dp > 1 else (0, b)
    res = dict(tokens=out.tokens, gen_lens=out.gen_lens, steps=out.steps,
               rows=rows)
    if weights == "w8a16":        # for the near-tie clause
        res.update(logits=logits, sampled=sampled_tokens)
    return res


def speculate(data, mesh, name: str, done: dict) -> dict:
    """Speculative decode case ``name`` (``<mesh>_<kind>``, the kind one of
    :data:`SPECS`), greedy but for "spec_sampled", drafted from the tokens
    of its sequential case on the same mesh (``done``: the cases run so
    far; under dp the ranks gather the whole batch's trace, whose rows each
    rank's draft takes) or by ``data["mtp"]``'s heads."""
    prefix, kind = name.split("_", 1)
    base, kv, draft = SPECS[kind]
    weights, _, b, _, _ = DECODES[base]
    cfg = data["cfg"]
    params = shard(data, weights, mesh)
    if draft == "mtp":
        draft_fn = speculative.mtp_draft_fn(data["mtp"])
    else:
        trace = done[f"{prefix}_{base}"]["tokens"]
        if mesh.dp > 1:
            trace = mesh_mod.all_gather(trace, 0, mesh.data_group, mesh.dp)
        draft_fn = speculative.trace_draft_fn(
            drafted_trace(trace, cfg.audio_vocab_size), SPEC_K)
    os.environ["T5G_FUSED_ATTN"] = "3"
    try:
        with tp.model_parallel(mesh):
            out = speculative.decode_tokens_speculative(
                params, cfg, decode_config(base, kv), *inputs(data, b, mesh),
                seed=7, draft_fn=draft_fn, k=SPEC_K)
    finally:
        os.environ.pop("T5G_FUSED_ATTN", None)
    rows = mesh_mod.batch_rows(b, mesh) if mesh.dp > 1 else (0, b)
    return dict(tokens=out.tokens, gen_lens=out.gen_lens, steps=out.steps,
                passes=out.passes, rows=rows)


def run_continuous(data, mesh, dp: bool) -> dict:
    """The JAX tests' continuous recipes (dp: 8 slots, three requests
    admitted at slots 0, 3 and 6 between segments of 5 and 4 steps; tp: 4
    slots, two requests at slots 1 and 2 after 6 steps), drained in
    segments of 16 steps: the rank's streams by global slot."""
    cfg, dcfg = data["cont_cfg"], DecodeConfig(max_frames=32,
                                                kv_cache="dense", **SAMPLED)
    params = shard(data, "f32", mesh)
    fns = continuous.make_fns(cfg, dcfg, graphed=False)
    reqs = data["cont_dp" if dp else "cont_tp"]
    b, tx, pmax = (8 if dp else 4), 10, 4
    with tp.model_parallel(mesh):
        state = continuous.init_slots(cfg, dcfg, b, tx, pmax, device="cpu")
        if dp:
            state = parallel.shard_slot_state(state, mesh)
            plan = [(0, 0, 5), (3, 1, 4), (6, 2, 0)]
        else:
            plan = [(1, 0, 6), (2, 1, 0)]
        for slot, i, steps in plan:
            state = fns.admit(params, state, slot, *reqs[i])
            if steps:
                state = fns.segment(params, state, steps)
        got = {}
        for _ in range(12):
            state = fns.segment(params, state, 16)
            state, outs = continuous.harvest(state)
            got.update({slot: torch.from_numpy(t) for slot, t in outs})
            if not bool(state.active.any()):
                break
    return dict(streams=got)


def decode_stack_over_group(data, mesh, int4: bool) -> dict:
    """Two layers of the ``test`` preset's widths through
    ``tp.decode_stack`` over the group (the decode layer's parts, the
    collectives between them) against the one-process
    ``decode_stack_plain``."""
    cfg = data["cfg"]
    dims = dataclasses.replace(cfg.backbone.decoder, num_layers=2,
                               layer_types=())
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, decoder=dims))
    layers = chip_smoke.random_quant_layers(dims, 2, "cpu", seed=4,
                                            int4=int4)
    b = 1 if int4 else 4
    args = chip_smoke.decode_layer_inputs(
        dims, b, True, prompt=37, gen_lens=[129, 5, 0, 300][:b],
        enc_lens=[44, 1, 29, 130][:b], gen_slab=384, device="cpu", seed=6)
    want = mk.decode_stack_plain(layers, dims, **args)
    local = parallel.serving_shard({"decoder": {"layers": layers}}, cfg,
                                   mesh)["decoder"]["layers"]
    cut, lo = chip_smoke.rank_layer_args(args, dims, mesh)
    hkv = cut["prompt_k"].shape[0]
    with tp.model_parallel(mesh):
        h, k, v = tp.decode_stack(local, dims, tp.local_dims(local, dims)[0],
                                  **cut)
    return dict(h_equal=bool(torch.equal(h, want[0])),
                k_equal=bool(torch.equal(k, want[1][:, :, lo:lo + hkv])),
                v_equal=bool(torch.equal(v, want[2][:, :, lo:lo + hkv])),
                h_err=float((h - want[0]).abs().max()))


def refusals(data, mesh) -> dict:
    """Each path that still refuses at tp > 1 (:data:`REFUSALS`): the
    message it raised (None: it did not raise)."""
    cfg = data["cfg"]
    params = shard(data, "f32", mesh)
    ins = inputs(data, 4)
    out = {}

    def attempt(name, fn):
        try:
            with tp.model_parallel(mesh):
                fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)

    attempt("graphed_decoder", lambda: engine._prefilled_session(
        params, cfg, DecodeConfig(top_k=1, kv_cache="paged", max_frames=4),
        *ins, seed=0, stream=False))
    dcfg = DecodeConfig(max_frames=8, kv_cache="dense")

    def capture():
        state = continuous.init_slots(cfg, dcfg, 2, 10, 4, device="cpu")
        continuous.make_fns(cfg, dcfg).capture(params, state)

    attempt("continuous_capture", capture)
    return dict(raised=out)


def run_case(data, name, mesh, done) -> dict:
    kind = name.partition("_")[2]
    if kind in SPECS:
        return speculate(data, mesh, name, done)
    if name.startswith("cont_"):
        return run_continuous(data, mesh, dp=name == "cont_dp2")
    if name.startswith("stack_"):
        return decode_stack_over_group(data, mesh,
                                       int4=name.endswith("int4"))
    if name == "refusals":
        return refusals(data, mesh)
    return decode(data, mesh, kind)


def main():
    group, outdir = sys.argv[1], sys.argv[2]
    parallel.init_distributed("cpu", timeout=TIMEOUT)
    data = torch.load(os.path.join(outdir, "inputs.pt"), weights_only=False)
    rank = int(os.environ["RANK"])
    meshes, done = {}, {}
    for name, (dp, tp_size) in {"two": TWO, "four": FOUR}[group]:
        if (dp, tp_size) not in meshes:
            meshes[dp, tp_size] = parallel.make_mesh(dp=dp, tp=tp_size)
        try:
            res = run_case(data, name, meshes[dp, tp_size], done)
        except Exception:
            res = dict(error=traceback.format_exc())
        done[name] = res
        torch.save(res, os.path.join(outdir, f"{name}.rank{rank}.pt"))
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
