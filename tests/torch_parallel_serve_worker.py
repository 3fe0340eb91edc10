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
  B = 4 and int4 ``paged_i8`` B = 1; dp 2 sampled bf16 B = 4; continuous
  dp 2 over ``shard_slot_state`` and continuous tp 2 (the JAX tests'
  recipe, dense cache); the int8 and int4 decode stacks over the real
  group against the plain one-process stack; every part-D refusal.
- ``four`` (world 4): tp 4 (the ``test`` preset's 2 kv heads do not
  divide 4: attention stays whole, the MLP and the head split) greedy
  bf16, int8 and int4; dp 2 x tp 2 greedy bf16 and int8, and sampled.
"""

import dataclasses
import os
import sys
import traceback
from datetime import timedelta

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from t5gemma_tts_tpu_torch import parallel  # noqa: E402
from t5gemma_tts_tpu_torch.config import DecodeConfig  # noqa: E402
from t5gemma_tts_tpu_torch.decode import continuous, engine  # noqa: E402
from t5gemma_tts_tpu_torch.decode import speculative  # noqa: E402
from t5gemma_tts_tpu_torch.models import t5gemma  # noqa: E402
from t5gemma_tts_tpu_torch.ops import megakernel as mk  # noqa: E402
from t5gemma_tts_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from t5gemma_tts_tpu_torch.parallel import tensor as tp  # noqa: E402

torch.set_num_threads(1)
TIMEOUT = timedelta(seconds=120)
MAX_FRAMES = 48
SAMPLED = dict(top_k=8, top_p=0.9, temperature=0.8)
# decode cases: (weights, kv cache, batch rows, sampled)
DECODES = {"bf16": ("f32", "paged", 4, False),
           "int8": ("int8", "paged_i8", 4, False),
           "int4": ("int4", "paged_i8", 1, False),
           "sampled": ("f32", "paged", 4, True)}
TWO = [("tp2_bf16", (1, 2)), ("tp2_int8", (1, 2)), ("tp2_int4", (1, 2)),
       ("dp2_sampled", (2, 1)), ("cont_dp2", (2, 1)), ("cont_tp2", (1, 2)),
       ("stack_tp2_int8", (1, 2)), ("stack_tp2_int4", (1, 2)),
       ("refusals", (1, 2))]
FOUR = [("tp4_bf16", (1, 4)), ("tp4_int8", (1, 4)), ("tp4_int4", (1, 4)),
        ("dp2tp2_bf16", (2, 2)), ("dp2tp2_int8", (2, 2)),
        ("dp2tp2_sampled", (2, 2))]
# part-D paths that must raise at tp > 1
REFUSALS = ("mode0", "mode1", "w8a16", "paged_f8", "speculative",
            "paged_decode_multi", "graphed_decoder", "continuous_capture")


def shard(data, weights: str, mesh):
    """This rank's serving tree for ``weights`` ("f32", "int8", "int4")."""
    whole = data["p1"] if weights == "int4" else data["p3"]
    bits = {"f32": None, "int8": 8, "int4": 4}[weights]
    return parallel.serving_shard(whole, data["cfg"], mesh,
                                  quantize=bits is not None,
                                  weight_bits=bits or 8)


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
    weights, kv, b, sampled = DECODES[kind]
    params = shard(data, weights, mesh)
    dcfg = DecodeConfig(top_k=SAMPLED["top_k"] if sampled else 1,
                        kv_cache=kv, max_frames=MAX_FRAMES,
                        **({k: v for k, v in SAMPLED.items() if k != "top_k"}
                           if sampled else {}))
    os.environ["T5G_FUSED_ATTN"] = "3"
    try:
        with tp.model_parallel(mesh):
            out = engine.decode_tokens(params, data["cfg"], dcfg,
                                       *inputs(data, b, mesh), seed=7)
    finally:
        os.environ.pop("T5G_FUSED_ATTN", None)
    rows = mesh_mod.batch_rows(b, mesh) if mesh.dp > 1 else (0, b)
    return dict(tokens=out.tokens, gen_lens=out.gen_lens, steps=out.steps,
                rows=rows)


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
    """Each part-D path at tp > 1: the message it raised (None: it did
    not raise)."""
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

    def with_mode(mode):
        def run():
            os.environ["T5G_FUSED_ATTN"] = mode
            try:
                engine.decode_tokens(params, cfg, DecodeConfig(
                    top_k=1, kv_cache="paged", max_frames=4), *ins, seed=0)
            finally:
                os.environ.pop("T5G_FUSED_ATTN", None)
        return run

    attempt("mode0", with_mode("0"))
    attempt("mode1", with_mode("1"))
    attempt("w8a16", lambda: parallel.serving_shard(
        data["p3"], cfg, mesh, quantize=True, act_bits=16))
    attempt("paged_f8", lambda: engine.decode_tokens(
        params, cfg, DecodeConfig(top_k=1, kv_cache="paged_f8",
                                  max_frames=4), *ins, seed=0))
    attempt("speculative", lambda: speculative.decode_tokens_speculative(
        params, cfg, DecodeConfig(top_k=1, kv_cache="paged", max_frames=4),
        *ins, seed=0, draft_fn=None, k=2))
    attempt("paged_decode_multi", lambda: t5gemma.paged_decode_multi(
        params["decoder"], cfg.backbone.decoder, inputs_embeds=None,
        position_ids=None, pm_decoder_positions=None, cache=None,
        pending_k=None, pending_v=None, flush_start=0, step=0,
        prompt_lengths=None, enc_lengths=None))
    attempt("graphed_decoder", lambda: engine._prefilled_session(
        params, cfg, DecodeConfig(top_k=1, kv_cache="paged", max_frames=4),
        *ins, seed=0, stream=False))
    dcfg = DecodeConfig(max_frames=8, kv_cache="dense")

    def capture():
        state = continuous.init_slots(cfg, dcfg, 2, 10, 4, device="cpu")
        continuous.make_fns(cfg, dcfg).capture(params, state)

    attempt("continuous_capture", capture)
    return dict(raised=out)


def run_case(data, name, mesh) -> dict:
    if name.startswith("cont_"):
        return run_continuous(data, mesh, dp=name == "cont_dp2")
    if name.startswith("stack_"):
        return decode_stack_over_group(data, mesh,
                                       int4=name.endswith("int4"))
    if name == "refusals":
        return refusals(data, mesh)
    return decode(data, mesh, name.split("_", 1)[1])


def main():
    group, outdir = sys.argv[1], sys.argv[2]
    parallel.init_distributed("cpu", timeout=TIMEOUT)
    data = torch.load(os.path.join(outdir, "inputs.pt"), weights_only=False)
    rank = int(os.environ["RANK"])
    meshes = {}
    for name, (dp, tp_size) in {"two": TWO, "four": FOUR}[group]:
        if (dp, tp_size) not in meshes:
            meshes[dp, tp_size] = parallel.make_mesh(dp=dp, tp=tp_size)
        try:
            res = run_case(data, name, meshes[dp, tp_size])
        except Exception:
            res = dict(error=traceback.format_exc())
        torch.save(res, os.path.join(outdir, f"{name}.rank{rank}.pt"))
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
