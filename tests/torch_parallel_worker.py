"""One rank of the port's gloo runs for ``tests/test_torch_parallel.py``.

Launched once per rank with torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``):

    python tests/torch_parallel_worker.py {two,four,cli} OUTDIR

Imports only ``torch``, numpy and the port. Rank 0 writes one JSON file a
case into OUTDIR (``four`` also ``four.pt``: the updated parameters and the
metrics, which the test holds to the JAX package's step):

- ``two`` (world 2): dp 2 with ZeRO-1 and ScaledAdam, four steps, with a
  save after step 1 restored at world 2 and at world 1, and the ZeRO-1
  state equal to ``shard_opt_state`` of the state over the whole blocks;
  tp 2 full model with rematerialized layers, four ScaledAdam steps; both
  ScaledAdam cases at periods of 2, so that the rms refresh, the
  learned-scale step and the clip run over the mesh, and the whole
  optimizer state held too; tp 2 LoRA; dp 2 AdamW with
  ZeRO-1; and Eve over the tp 2 and the dp 2 ZeRO-1 layouts on identical
  seeded gradients (1e-5 of each leaf's largest element). Then
  ``Trainer`` over ``OUTDIR/ds`` for a step and a validation at dp 2 with
  ZeRO-1, tp 2 and LoRA at tp 2, and alone. Each held to the one-process port
  step over the same global batch (each updated leaf within 1e-5 relative
  in its Frobenius norm, the metrics within 1e-5).
- ``four`` (world 4): dp 2 x tp 2 with ZeRO-1, one ScaledAdam step on the
  weights and batch in ``OUTDIR/inputs.npz``.
- ``cli`` (world 2): ``train.cli.main`` for two steps for each argv of
  ``OUTDIR/spec.json``, then ``preprocess.prepare`` over its wavs.
"""

import json
import os
import sys
import traceback
from datetime import timedelta

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from t5gemma_tts_tpu_torch import parallel  # noqa: E402
from t5gemma_tts_tpu_torch.config import tiny_voice_config  # noqa: E402
from t5gemma_tts_tpu_torch.models import voice  # noqa: E402
from t5gemma_tts_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from t5gemma_tts_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from t5gemma_tts_tpu_torch.train import lora, optim  # noqa: E402
from t5gemma_tts_tpu_torch.train import train_step as ts  # noqa: E402
from t5gemma_tts_tpu_torch.utils.tree import (  # noqa: E402
    from_paths, keystr, leaves_with_path, parse_keystr, tree_map, unflatten)

torch.set_num_threads(1)
TIMEOUT = timedelta(seconds=120)
RTOL = 1e-5
# the tp 2 LoRA case's two-step trajectory (its reading: 3e-5, see
# case_tp_lora)
LORA_FRO = 1e-4
# The learned scale's state holds sgrads = sum(p * g) of a layer, a sum
# with heavy cancellation in the tiny model (attention v and o: 1e-6
# against 1e-2 of sum |p * g|), so a change in its order of summation (the
# blocks' sums, then the model group's) moves it by 1e-4 relative: the
# one-process f32 sum itself lies 8e-5 to 1.6e-4 from the f64 sum. The
# limits of one step from the same gradients, by field (readings at tp 2;
# at dp 2 every leaf is bit-equal): the learned scale's state (1.5e-4) and
# ``delta``, which takes the learned-scale step (1.2e-5 on those steps, 0
# on the others); the new parameters (3e-8) and every other field
# (param_rms, exp_avg_sq, the clip's norms and threshold: 0) to RTOL.
FIELD_TOL = {"['scale_grads']": ("scale_err", 2e-3),
             "['scale_exp_avg_sq']": ("scale_err", 2e-3),
             "['delta']": ("delta_err", 1e-4)}
# and the whole optimizer state's after four steps, which also carries the
# gradients' 1e-6 differences (reading: 5.1e-4; the parameters are held to
# RTOL):
OPT_FRO = 5e-3
LR = 0.01
ADAMW_LR = 1e-4
METRICS = ("loss", "mean_ce", "perplexity", "top10acc", "ntokens",
           "grad_norm")
# periods of 2 over four steps (s = 0..3): the rms refresh and the
# learned-scale step at s = 1 and 3, the clip threshold's refresh at s = 2
# and the clip at s = 2 and 3
PERIODIC = optim.ScaledAdamConfig(size_update_period=2,
                                  clipping_update_period=2)


def batch(rng, cfg, n_micro=2, b=4, tx=12, ty=20):
    """A global batch whose targets hold y_sep tokens, so that a rank's CE
    weight differs from its token count."""
    y = rng.integers(0, cfg.audio_vocab_size, (n_micro, b, ty))
    y[rng.random(y.shape) < 0.15] = cfg.special.y_sep
    return dict(
        x=rng.integers(3, 500, (n_micro, b, tx)).astype(np.int32),
        x_lens=rng.integers(4, tx + 1, (n_micro, b)).astype(np.int32),
        y=y.astype(np.int32),
        y_lens=rng.integers(5, ty + 1, (n_micro, b)).astype(np.int32),
        y_sep_position=np.zeros((n_micro, b), np.int32))


def torch_batch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def fro_worst(got, want) -> float:
    """The worst leaf's relative Frobenius distance."""
    worst = 0.0
    for (_, a), (_, b) in zip(leaves_with_path(got), leaves_with_path(want)):
        a, b = a.detach().double(), b.detach().double()
        worst = max(worst, float(torch.linalg.vector_norm(a - b))
                    / max(float(torch.linalg.vector_norm(b)), 1e-30))
    return worst


def metric_worst(got, want) -> float:
    return max(abs(float(getattr(got, f)) - float(getattr(want, f)))
               / max(abs(float(getattr(want, f))), 1e-30) for f in METRICS)


def bit_equal(a, b) -> bool:
    la, lb = list(leaves_with_path(a)), list(leaves_with_path(b))
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        x.dtype == y.dtype and torch.equal(x, y)
        for (_, x), (_, y) in zip(la, lb))


class Run:
    """One case's steps over a mesh, its trained tree's layout and specs."""

    def __init__(self, mesh, cfg, params, ocfg, zero, lcfg=None, lr=LR):
        self.mesh, self.cfg, self.ocfg, self.lcfg = mesh, cfg, ocfg, lcfg
        self.lr = lr
        self.pspecs = parallel.param_specs(params, cfg, mesh.tp)
        if lcfg is not None:
            ads = lora.init_adapters(torch.Generator().manual_seed(5),
                                     params, lcfg)
            self.base = parallel.shard_params(params, mesh, self.pspecs)
            target, specs = ads, parallel.param_specs(ads, cfg, mesh.tp)
        else:
            target = parallel.shard_params(params, mesh, self.pspecs)
            specs = self.pspecs
        self.layout = parallel.Layout(mesh, specs, target, zero=zero)
        self.state = ts.init_state(target, ocfg, self.layout)
        self.specs = mesh_mod.state_specs(self.state, self.layout)
        if lcfg is None:
            self.fn = ts.make_train_step(cfg, ocfg, self.layout)
        else:
            step = ts.make_lora_train_step(cfg, ocfg, lcfg, self.layout)

            def fn(state, b, lr):
                ads, opt, m = step(state.params, state.opt, self.base, b, lr)
                return state._replace(params=ads, opt=opt,
                                      step=state.step + 1), m

            self.fn = fn

    def step(self, global_batch):
        b = torch_batch(parallel.shard_batch(global_batch, self.mesh, axis=1))
        self.state, m = self.fn(self.state, b, torch.tensor(self.lr))
        return m

    def held_step(self, global_batch):
        """:meth:`step` in its two halves (the gradients, then the update
        under the NaN guard), the update held to the one-process optimizer
        on the same gradients, parameters and state (gathered) -> (metrics,
        {check: the worst relative Frobenius distance of its leaves}: the
        checks of FIELD_TOL, and "update_err" over the new parameters and
        the other fields). Full-model runs only."""
        b = torch_batch(parallel.shard_batch(global_batch, self.mesh, axis=1))
        st, lr, specs = self.state, torch.tensor(self.lr), self.layout.specs

        def forward(p, mb):
            return voice.forward(p, self.cfg, mb)

        grads, sums = ts.accumulate_grads(st.params, b, forward, self.mesh)
        want_p, want_o = optim.update(
            parallel.gather_params(grads, self.mesh, specs),
            unflatten(st.opt, whole_opt(self)), self.whole(), lr, self.ocfg)
        params, opt, m = ts.apply_grads(st.params, st.opt, grads, sums, lr,
                                        self.ocfg, self.layout)
        self.state = ts.TrainState(params=params, opt=opt, step=st.step + 1,
                                   nan_skips=st.nan_skips + m.nan_step)
        errs = dict(update_err=fro_worst(self.whole(), want_p),
                    scale_err=0.0, delta_err=0.0)
        for leaf, err in opt_fro(self, want_o).items():
            field = leaf[:leaf.index("]") + 1]
            check = FIELD_TOL.get(field, ("update_err", RTOL))[0]
            errs[check] = max(errs[check], err)
        return m, errs

    def whole(self):
        """The whole trained tree (collective)."""
        return parallel.gather_params(self.state.params, self.mesh,
                                      self.layout.specs)


def one_process(cfg, params, ocfg, batches, lcfg=None, state=None, lr=LR):
    """The one-process port steps over the same global batches."""
    if lcfg is None:
        state = state or ts.init_state(params, ocfg)
        fn = ts.make_train_step(cfg, ocfg)
    else:
        ads = lora.init_adapters(torch.Generator().manual_seed(5), params,
                                 lcfg)
        state = state or ts.init_state(ads, ocfg)
        step = ts.make_lora_train_step(cfg, ocfg, lcfg)

        def fn(st, b, lr):
            a, o, m = step(st.params, st.opt, params, b, lr)
            return st._replace(params=a, opt=o, step=st.step + 1), m
    metrics = []
    for b in batches:
        state, m = fn(state, torch_batch(b), torch.tensor(lr))
        metrics.append(m)
    return state, metrics


def whole_opt(run):
    """The whole optimizer state's leaves, in tree order (collective)."""
    return [mesh_mod.gather_leaf(t, s, run.mesh) for (_, t), (_, s) in zip(
        leaves_with_path(run.state.opt), leaves_with_path(run.specs.opt))]


def opt_fro(run, want_opt):
    """The whole optimizer state against one process's (every field:
    moments, param_rms, the learned scale's state, the clip's norms) ->
    {leaf: its relative Frobenius distance} (collective)."""
    return {keystr(path): fro_worst(got, want) for got, (path, want) in zip(
        whole_opt(run), leaves_with_path(want_opt))}


def state_errs(run, want_opt, steps):
    """The checks of the held steps and of the whole state at the end: the
    worst of each over the steps, the state's worst leaf and its
    distance."""
    opt = opt_fro(run, want_opt)
    worst = max(opt, key=opt.get)
    return dict({k: max(e[k] for e in steps) for k in steps[0]},
                opt_fro=opt[worst], opt_worst=worst)


def state_ok(errs) -> bool:
    tols = dict(FIELD_TOL.values(), update_err=RTOL, opt_fro=OPT_FRO)
    return all(errs[k] <= tol for k, tol in tols.items())


def held(name, got_params, want_params, got_m, want_m, extra=None):
    res = dict(case=name, fro=fro_worst(got_params, want_params),
               metrics=max(metric_worst(g, w) for g, w in zip(got_m, want_m)),
               losses=[float(m.loss) for m in got_m],
               want_losses=[float(m.loss) for m in want_m], **(extra or {}))
    res["ok"] = bool(res["fro"] <= RTOL and res["metrics"] <= RTOL
                     and res.get("ok_extra", True))
    return res


def moment_bytes(run):
    """(this rank's elements of the ZeRO-split moment leaves, those leaves'
    whole elements, how many leaves are split) for one moment field."""
    field = "exp_avg_sq" if hasattr(run.state.opt, "exp_avg_sq") else "nu"
    mine = whole = split = 0
    for i, (_, d) in enumerate(leaves_with_path(getattr(run.state.opt,
                                                        field))):
        if run.layout.zero_dims[i] is None:
            continue
        n = 1
        for x in run.layout.shapes[i]:
            n *= x
        mine += d.numel()
        # the rank's tensor-parallel block of the leaf, whole over dp
        whole += n // (run.mesh.tp if run.layout.split(i) else 1)
        split += 1
    return mine, whole, split


def eve_on_identical_grads(run, params) -> float:
    """Eve over the mesh (this rank's blocks and ZeRO-1 slices) against
    Eve in one process on the same seeded gradients, two updates: the
    worst leaf's largest difference over its largest element."""
    gen = torch.Generator().manual_seed(3)
    grads = [{p: torch.randn(t.shape, generator=gen) * 1e-3
              for p, t in leaves_with_path(params)} for _ in range(2)]

    def tree(flat):
        return from_paths(list(flat.items()))

    cfg, lr = optim.EveConfig(), torch.tensor(1e-3)
    mesh, specs = run.mesh, run.pspecs
    whole, st = params, optim.eve_init(params)
    local = parallel.shard_params(params, mesh, specs)
    st_l = optim.eve_init(local, run.layout)
    for g in grads:
        whole, st = optim.eve_update(tree(g), st, whole, lr, cfg)
        g_l = parallel.shard_params(tree(g), mesh, specs)
        local, st_l = optim.eve_update(g_l, st_l, local, lr, cfg,
                                       run.layout)
    return max_rel(parallel.gather_params(local, mesh, specs), whole)


def case_dp_zero_scaled(mesh, cfg, params, batches, outdir):
    ocfg = PERIODIC
    run = Run(mesh, cfg, params, ocfg, zero=True)
    mine, whole, split = moment_bytes(run)
    # the state over the whole blocks, cut by shard_opt_state: the same
    blocks = parallel.shard_params(params, mesh, run.pspecs)
    cut = parallel.shard_opt_state(
        optim.init(blocks, ocfg), mesh,
        parallel.opt_state_specs(run.state.opt, run.layout))
    sliced_init = bit_equal(cut, run.state.opt)
    m1, e1 = run.held_step(batches[0])
    exp = os.path.join(outdir, "zero_exp")
    ckpt.save_bundle(exp, run.state, {"step": 1}, mesh=mesh, specs=run.specs)
    after1 = parallel.gather_params(run.state.params, mesh, run.layout.specs)
    opt1 = whole_opt(run)
    m2, e2 = run.held_step(batches[1])
    whole2 = run.whole()
    uninterrupted = [t.clone() for _, t in leaves_with_path(run.state)]
    # restore at world 2 into a fresh run, and go on
    again = Run(mesh, cfg, params, ocfg, zero=True)
    again.state, _, _ = ckpt.restore_bundle(exp, again.state, mesh=mesh,
                                            specs=again.specs)
    again.step(batches[1])
    resumed2 = all(torch.equal(a, t) for a, (_, t) in zip(
        uninterrupted, leaves_with_path(again.state)))
    rest = [run.held_step(b) for b in batches[2:]]
    ms = [m1, m2] + [m for m, _ in rest]
    want_state, want_m = one_process(cfg, params, ocfg, batches)
    extra = dict(moment_elems=mine, moment_whole=whole, zero_split=split,
                 resumed_world2_exact=resumed2,
                 shard_opt_state_exact=sliced_init,
                 **state_errs(run, want_state.opt,
                              [e1, e2] + [e for _, e in rest]))
    if mesh.lead:
        # restore at world 1 (rank 0 alone): the gathered state exactly,
        # and its step 2 held to the mesh's
        tmpl = ts.init_state(params, ocfg)
        alone, _, _ = ckpt.restore_bundle(exp, tmpl)
        flat1 = [t for _, t in leaves_with_path(alone.opt)]
        extra["restored_world1_exact"] = bit_equal(alone.params, after1) and \
            all(torch.equal(a, b) for a, b in zip(flat1, opt1))
        st, _ = one_process(cfg, params, ocfg, batches[1:2], state=alone)
        extra["world1_continuation_fro"] = fro_worst(st.params, whole2)
        extra["ok_extra"] = bool(
            resumed2 and sliced_init and extra["restored_world1_exact"]
            and extra["world1_continuation_fro"] <= RTOL
            and state_ok(extra)
            and split > 0 and mine * mesh.dp <= whole)
    return held("dp2_zero_scaledadam", run.whole(), want_state.params, ms,
                want_m, extra)


def case_tp_full(mesh, cfg, params, batches, outdir):
    """With every layer rematerialized: the backward's recomputed
    forwards run the model group's collectives again."""
    cfg = tiny_voice_config(gradient_checkpointing=True)
    ocfg = PERIODIC
    run = Run(mesh, cfg, params, ocfg, zero=False)
    steps = [run.held_step(b) for b in batches]
    want_state, want_m = one_process(cfg, params, ocfg, batches)
    split = sum(d is not None for d in run.layout.tp_dims)
    eve = eve_on_identical_grads(run, params)
    errs = state_errs(run, want_state.opt, [e for _, e in steps])
    return held("tp2_full", run.whole(), want_state.params,
                [m for m, _ in steps], want_m,
                dict(tp_split_leaves=split, eve_err=eve, **errs,
                     ok_extra=split > 0 and eve <= RTOL and state_ok(errs)))


def max_rel(got, want) -> float:
    """The worst leaf's largest difference over its largest element."""
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for (_, a), (_, b) in zip(leaves_with_path(got),
                                         leaves_with_path(want)))


def case_tp_lora(mesh, cfg, params, batches, outdir):
    """Held by the protocol's parts: the adapters' zero-initialized ``b``
    moves by lr (1 - beta1) min_rms g / (|g| + eps) on its first steps, so
    an element whose gradient lies near eps carries its rounding across
    the whole of its move (3e-5 of the leaf's norm here, its gradient
    within 2e-6). So each step's gradients from the same state are held to
    the one-process step's (Frobenius, 1e-5), the mesh's optimizer update
    to the one-process optimizer on those gradients (1e-5 of each leaf's
    largest element), the metrics of the two-step run to 1e-5 and its
    adapters to ``LORA_FRO`` (Frobenius); and
    ``lora.apply`` on this rank's blocks, gathered, equals it on the whole
    base (random adapters)."""
    ocfg = optim.ScaledAdamConfig(clipping_update_period=4)
    lcfg = lora.LoraConfig(r=4, alpha=8)
    run = Run(mesh, cfg, params, ocfg, zero=False, lcfg=lcfg)
    grad_fro = update_err = 0.0
    ms = []

    def forward(base):
        return lambda a, mb: voice.forward(lora.wrap(base, a, lcfg), cfg, mb)

    for b in batches:
        before = run.state
        g_mesh, _ = ts.accumulate_grads(
            before.params, torch_batch(parallel.shard_batch(b, mesh, axis=1)),
            forward(run.base), mesh)
        g_one, _ = ts.accumulate_grads(before.params, torch_batch(b),
                                       forward(params))
        grad_fro = max(grad_fro, fro_worst(g_mesh, g_one))
        plain, _ = optim.update(g_mesh, before.opt, before.params,
                                torch.tensor(LR), ocfg)
        ms.append(run.step(b))
        update_err = max(update_err, max_rel(run.state.params, plain))
    want_state, want_m = one_process(cfg, params, ocfg, batches, lcfg=lcfg)
    # lora.apply on this rank's blocks, with adapters far from their init
    gen = torch.Generator().manual_seed(7)
    ads = tree_map(lambda t: torch.randn(t.shape, generator=gen) * 0.1,
                   run.state.params)
    applied = parallel.gather_params(
        lora.apply(run.base, ads, lcfg, mesh.tp_rank), mesh, run.pspecs)
    apply_exact = bit_equal(applied, lora.apply(params, ads, lcfg))
    res = dict(case="tp2_lora", grad_fro=grad_fro, update_err=update_err,
               apply_exact=apply_exact,
               fro=fro_worst(run.state.params, want_state.params),
               metrics=max(metric_worst(g, w) for g, w in zip(ms, want_m)),
               losses=[float(m.loss) for m in ms],
               want_losses=[float(m.loss) for m in want_m])
    res["ok"] = bool(grad_fro <= RTOL and update_err <= RTOL
                     and res["metrics"] <= RTOL and apply_exact
                     and res["fro"] <= LORA_FRO)
    return res


def case_dp_zero_adamw(mesh, cfg, params, batches, outdir):
    """At the train CLI's default AdamW rate (1e-4). At 1e-2 a first step
    moves every element by half a weight's scale, and the elements whose
    gradient lies near Adam's eps (1e-8) carry their gradients' rounding
    differences far into that move (up to 8e-5 of 1e-2 here, the
    gradients themselves within 1e-6 per leaf)."""
    ocfg = optim.AdamWConfig()
    run = Run(mesh, cfg, params, ocfg, zero=True, lr=ADAMW_LR)
    mine, whole, split = moment_bytes(run)
    ms = [run.step(b) for b in batches]
    want_state, want_m = one_process(cfg, params, ocfg, batches,
                                     lr=ADAMW_LR)
    eve = eve_on_identical_grads(run, params)
    return held("dp2_zero_adamw", run.whole(), want_state.params, ms, want_m,
                dict(moment_elems=mine, moment_whole=whole, zero_split=split,
                     eve_err=eve, ok_extra=bool(
                         split > 0 and mine * mesh.dp <= whole
                         and eve <= RTOL)))


TRAINER_RUNS = {"dp2": ((2, 1), False), "tp2": ((1, 2), False),
                "lora_tp2": ((1, 2), True)}


def train_one_step(outdir, name, mesh, lora_on):
    """``Trainer`` over ``OUTDIR/ds`` for one ScaledAdam step and a
    validation (ZeRO-1 on: it splits where the mesh has dp > 1) ->
    (the validation loss, the step's loss)."""
    from t5gemma_tts_tpu_torch.data.dataset import VoiceDataset
    from t5gemma_tts_tpu_torch.data.manifest import DataConfig
    from t5gemma_tts_tpu_torch.train import trainer as tr

    cfg = tiny_voice_config()
    dcfg = DataConfig(dataset_dir=os.path.join(outdir, "ds"),
                      audio_min_length=0.1, audio_max_length=1.0,
                      encodec_sr=50.0, neighbor_prompt_prob=1.0,
                      min_prompt_len=0.05)

    def tokenizer(text):
        return [3 + (ord(c) % (cfg.text_vocab_size - 10))
                for c in text][:100]

    args = (tokenizer, cfg.x_sep_token, cfg.special.y_sep)
    tcfg = tr.TrainerConfig(
        exp_dir=os.path.join(outdir, name), lr=0.01, num_steps=1,
        val_every_n_steps=1, max_num_tokens=256, val_max_num_tokens=256,
        num_buckets=2, text_max_length=64, early_stop_step=0, num_epochs=50,
        optimizer_name="ScaledAdam", use_lora=lora_on, lora_r=4,
        lora_alpha=8, zero_opt_sharding=True)
    t = tr.Trainer(cfg, tcfg, VoiceDataset(dcfg, "train", *args, seed=1),
                   VoiceDataset(dcfg, "valid", *args, seed=1),
                   params=voice.init_params(1, cfg, "cpu"), mesh=mesh,
                   device="cpu")
    return t.train()["best_score"], t.history[0]["loss"]


def case_trainers(outdir):
    """``Trainer`` over a mesh for a step and a validation: dp 2 with
    ZeRO-1, tp 2, and LoRA at tp 2 (validated through ``lora.apply`` on
    this rank's blocks); the test holds each to one process's."""
    return dict(case="trainers", runs={
        name: train_one_step(outdir, f"trainer_{name}",
                             parallel.make_mesh(dp=dp, tp=tp), lora_on)
        for name, ((dp, tp), lora_on) in TRAINER_RUNS.items()})


def run_two(outdir):
    cfg = tiny_voice_config()
    params = voice.init_params(0, cfg, "cpu")
    rng = np.random.default_rng(1)
    batches = [batch(rng, cfg) for _ in range(4)]
    # (mesh, case, its steps' batches): four for the ScaledAdam cases
    cases = [((2, 1), case_dp_zero_scaled, 4), ((1, 2), case_tp_full, 4),
             ((1, 2), case_tp_lora, 2), ((2, 1), case_dp_zero_adamw, 2)]
    meshes = {}
    for (dp, tp), fn, steps in cases:
        if (dp, tp) not in meshes:
            meshes[dp, tp] = parallel.make_mesh(dp=dp, tp=tp)
        mesh = meshes[dp, tp]
        try:
            res = fn(mesh, cfg, params, batches[:steps], outdir)
        except Exception:
            res = dict(case=fn.__name__, ok=False,
                       error=traceback.format_exc())
        if mesh.lead:
            with open(os.path.join(outdir, f"{res['case']}.json"), "w") as f:
                json.dump(res, f)
    res = case_trainers(outdir)
    if int(os.environ["RANK"]) == 0:
        with open(os.path.join(outdir, "trainers.json"), "w") as f:
            json.dump(res, f)


def run_four(outdir):
    data = np.load(os.path.join(outdir, "inputs.npz"))
    params = from_paths([(parse_keystr(k[2:]), torch.from_numpy(data[k]))
                         for k in data.files if k.startswith("p:")])
    b = {k[2:]: data[k] for k in data.files if k.startswith("b:")}
    cfg = tiny_voice_config(ce_vocab_chunk=int(data["chunk"]))
    ocfg = optim.ScaledAdamConfig(clipping_scale=None)
    mesh = parallel.make_mesh(dp=2, tp=2)
    run = Run(mesh, cfg, params, ocfg, zero=True)
    m = run.step(b)
    whole = run.whole()
    mine, total, split = moment_bytes(run)
    if mesh.lead:
        torch.save({"params": {keystr(p): t for p, t in
                               leaves_with_path(whole)},
                    "metrics": {f: float(getattr(m, f)) for f in METRICS},
                    "moment_elems": mine, "moment_whole": total,
                    "zero_split": split,
                    "tp_split": sum(d is not None
                                    for d in run.layout.tp_dims)},
                   os.path.join(outdir, "four.pt"))


def run_cli(outdir):
    with open(os.path.join(outdir, "spec.json")) as f:
        spec = json.load(f)
    from t5gemma_tts_tpu_torch.data import preprocess
    from t5gemma_tts_tpu_torch.train import cli, trainer

    made = []
    init = trainer.Trainer.__init__

    def recording(self, *a, **k):
        init(self, *a, **k)
        made.append(self)

    trainer.Trainer.__init__ = recording
    runs = {}
    for name, argv in spec["train_argv"].items():
        made.clear()
        cli.main(argv)
        runs[name] = {"history": made[0].history,
                      "mesh": [made[0].mesh.dp, made[0].mesh.tp]}
    rank = int(os.environ["RANK"])
    mesh = parallel.make_mesh()
    tok = preprocess._cli_tokenizer(
        preprocess.build_parser().parse_args(spec["prep_argv"]), "cpu")
    pcfg = preprocess.PreprocessConfig(out_dir=spec["prep_out"],
                                       encode_batch=3, valid_fraction=0.25)
    preprocess.prepare(preprocess.iter_wav_folder(
        spec["wavs"], tok.encode_sample_rate), tok, pcfg, mesh)
    if rank == 0:
        with open(os.path.join(outdir, "cli.json"), "w") as f:
            json.dump(runs, f)


def main():
    group, outdir = sys.argv[1], sys.argv[2]
    parallel.init_distributed("cpu", timeout=TIMEOUT)
    {"two": run_two, "four": run_four, "cli": run_cli}[group](outdir)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
