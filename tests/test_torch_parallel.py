"""The port's data- and tensor-parallel training (``parallel/``) on the CPU.

(a) ``param_specs`` equals JAX ``parallel.param_specs`` leaf for leaf on a
``make_mesh(dp, tp)`` over the 8 virtual CPU devices, for the ``test`` and
``2b-2b`` shapes (``jax.eval_shape`` / ``meta`` tensors, nothing
allocated), at (dp, tp) in {(4, 2), (2, 4), (8, 1)}, except the leaves
where the port's own rules part from JAX's, which are listed here: the
head's ``b1`` (split with ``w1``'s columns) everywhere, and the q/k/v/o
leaves of every attention where ``tp`` does not divide the kv heads (the
``test`` preset's 2 at tp 4: whole heads only); ``zero_spec`` equals
``_zero_spec`` on the leaves whose specs agree.
(b) ``shard_batch``'s rows per rank equal the spans of JAX
``NamedSharding(...).addressable_devices_indices_map`` at dp 4, tp 2,
axis 1.
(c) One two-rank gloo launch (``tests/torch_parallel_worker.py two``):
dp 2 with ZeRO-1 and ScaledAdam for four steps (a save after step 1
restored at world 2, the continuation bit-equal to the uninterrupted
run, and at world 1, the restored state bit-equal to the gathered one and
its step held to the mesh's; the ZeRO-1 state bit-equal to
``shard_opt_state`` of the state over the whole blocks), tp 2 full model
with rematerialized layers for four steps (both ScaledAdam cases at
periods of 2, so that the rms refresh, the learned-scale step and the clip
run over the mesh; each step's update held to the one-process optimizer on
the same gradients: the new parameters and the state within 1e-5, but
the learned scale's state within 2e-3 (a sum with heavy cancellation) and
``delta``, which takes its step, within 1e-4; and the whole state at the
end within 5e-3), tp 2 LoRA and dp 2 AdamW with ZeRO-1, each
against the one-process port step over the same global batch under the
repo's Adam-type protocol (updated leaves within 1e-5 relative in their
Frobenius norm, metrics within 1e-5; the LoRA case by the protocol's
parts and AdamW at the CLI's default rate, see the worker), and each
ZeRO-1 rank's moments at most 1/dp of the split leaves'.
Then, in the same launch, ``Trainer`` for a step and a validation at dp 2
with ZeRO-1, tp 2 and LoRA at tp 2, its losses and validation loss within
1e-5 of one process's.
(d) One four-rank gloo launch at dp 2 x tp 2 with ZeRO-1 and the chunked
CE (64-column blocks) against JAX's single-device
``train_step.compile_train_step`` on the same weights and batch: loss
within 1e-4 relative, grad norm within 1e-3, updated leaves within 1e-5
relative Frobenius (JAX compiles while the ranks run).
The mesh's serving half is tested in ``tests/test_torch_parallel_serve.py``.

Each launch has a 300 s limit that kills its ranks, and every process
group a 120 s timeout, so a rank that misses a collective fails the test.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from t5gemma_tts_tpu import parallel as jpar
from t5gemma_tts_tpu.config import VoiceConfig as JVoiceConfig
from t5gemma_tts_tpu.config import tiny_voice_config as jtiny
from t5gemma_tts_tpu.models import voice as jvoice
from t5gemma_tts_tpu.train import optim as jopt
from t5gemma_tts_tpu.train import train_step as jts
from t5gemma_tts_tpu_torch import parallel as tpar
from t5gemma_tts_tpu_torch.config import VoiceConfig as TVoiceConfig
from t5gemma_tts_tpu_torch.config import tiny_voice_config as ttiny
from t5gemma_tts_tpu_torch.models import voice as tvoice
from t5gemma_tts_tpu_torch.parallel import mesh as tmesh
from t5gemma_tts_tpu_torch.utils.tree import keystr, leaves_with_path

sys.path.insert(0, os.path.dirname(__file__))
from test_data_and_trainer import _write_dataset  # noqa: E402
from torch_parallel_worker import TRAINER_RUNS, train_one_step  # noqa: E402

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
LAUNCH_TIMEOUT = 300
CHUNK = 64
TWO_CASES = ("dp2_zero_scaledadam", "tp2_full", "tp2_lora", "dp2_zero_adamw")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(group: str, world: int, outdir: str):
    """Start ``world`` ranks of the worker with torchrun's environment."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=ROOT)
        env.pop("PYTHONSTARTUP", None)
        log = open(os.path.join(outdir, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_parallel_worker.py"),
             group, outdir], env=env, stdout=log, stderr=subprocess.STDOUT,
            cwd=ROOT), log))
    return procs


def wait(procs, outdir: str) -> None:
    """Wait for every rank (killing all at the limit); each must exit 0."""
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


# ---------------------------------------------------------------------------
# (a) specs, (b) rows
# ---------------------------------------------------------------------------

ATTENTION = [f"['{stack}']['layers']['{attn}']['{name}']"
             for stack, attn in (("decoder", "cross_attn"),
                                 ("decoder", "self_attn"),
                                 ("encoder", "self_attn"))
             for name in "kqvo"]
B1 = "['head']['b1']"


def _parts(preset: str, tp: int):
    """The leaves where the port's specs part from JAX's, by name."""
    return set([B1] + (ATTENTION if preset == "tiny" and tp == 4 else []))


def _configs(preset):
    if preset == "tiny":
        return jtiny(), ttiny()
    return JVoiceConfig(), TVoiceConfig()


def _padded(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(tuple(spec)))


@pytest.mark.parametrize("preset", ["tiny", "2b-2b"])
@pytest.mark.parametrize("dp,tp", [(4, 2), (2, 4), (8, 1)])
def test_specs_equal_jax_but_at_the_listed_leaves(preset, dp, tp):
    jcfg, tcfg = _configs(preset)
    shapes = jax.eval_shape(
        lambda: jvoice.init_params(jax.random.PRNGKey(0), jcfg))
    mesh = jpar.make_mesh(dp=dp, tp=tp)
    jspecs = jpar.param_specs(shapes, mesh)
    meta = tvoice.init_params(0, tcfg, "meta")
    tspecs = tpar.param_specs(meta, tcfg, tp)
    jflat = {jax.tree_util.keystr(p): (s, leaf) for (p, s), (_, leaf) in zip(
        jax.tree_util.tree_flatten_with_path(
            jspecs, is_leaf=lambda v: isinstance(v, P))[0],
        jax.tree_util.tree_flatten_with_path(shapes)[0])}
    tflat = {keystr(p): s for p, s in leaves_with_path(tspecs)}
    assert sorted(jflat) == sorted(tflat)
    parted = set()
    for name, (jspec, leaf) in jflat.items():
        want = _padded(jspec, leaf.ndim)
        got = tflat[name].axes
        if got != want:
            parted.add(name)
            continue
        jz = _padded(jpar.mesh._zero_spec(jspec, leaf, mesh), leaf.ndim)
        assert tmesh.zero_spec(tflat[name], leaf.shape, dp).axes == jz, name
    assert parted == _parts(preset, tp), sorted(parted)
    for name in parted:       # what the port's rules say there
        want = ("model",) if name == B1 else (None,) * len(tflat[name].axes)
        assert tflat[name].axes == want, name


def test_shard_batch_rows_equal_jax_spans():
    mesh = jpar.make_mesh(dp=4, tp=2)
    gshape = (2, 8, 6)
    sharding = NamedSharding(mesh, P(None, "data"))
    idx = sharding.addressable_devices_indices_map(gshape)
    batch = {"x": np.arange(np.prod(gshape)).reshape(gshape)}
    for rank, dev in enumerate(mesh.devices.reshape(-1)):
        sl = idx[dev][1]
        want = (sl.start or 0, gshape[1] if sl.stop is None else sl.stop)
        tm = tpar.Mesh(dp=4, tp=2, rank=rank)
        assert tmesh.batch_rows(gshape[1], tm) == want, rank
        np.testing.assert_array_equal(
            tpar.shard_batch(batch, tm, axis=1)["x"],
            batch["x"][:, want[0]:want[1]])


# ---------------------------------------------------------------------------
# (c) two ranks against the one-process port step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Both launches at once, and JAX's single-device step compiled and
    run while they go: (two-rank results by case, four-rank outputs, JAX's
    updated leaves and metrics)."""
    two = str(tmp_path_factory.mktemp("two"))
    four = str(tmp_path_factory.mktemp("four"))
    jcfg = jtiny(ce_vocab_chunk=CHUNK)
    params = jvoice.init_params(jax.random.PRNGKey(0), jcfg)
    batch = _jax_batch(jcfg, np.random.default_rng(0))
    arrays = {"p:" + jax.tree_util.keystr(p): np.asarray(leaf)
              for p, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    arrays.update({"b:" + k: v for k, v in batch.items()})
    np.savez(os.path.join(four, "inputs.npz"), chunk=CHUNK, **arrays)
    _write_dataset(os.path.join(two, "ds"))
    procs = {two: launch("two", 2, two), four: launch("four", 4, four)}
    try:
        ocfg = jopt.ScaledAdamConfig(clipping_scale=None)
        step = jts.compile_train_step(jcfg, ocfg, donate=False)
        state, metrics = step(jts.init_state(params, ocfg),
                              {k: jnp.asarray(v) for k, v in batch.items()},
                              jnp.float32(0.01))
        want = {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf in
                jax.tree_util.tree_flatten_with_path(state.params)[0]}
        # and the trainers the two ranks run, in one process
        alone = {lora_on: train_one_step(two, f"alone_{lora_on}", None,
                                         lora_on)
                 for lora_on in (False, True)}
    finally:
        for out, ps in procs.items():
            wait(ps, out)
    res = {}
    for case in TWO_CASES + ("trainers",):
        with open(os.path.join(two, f"{case}.json")) as f:
            res[case] = json.load(f)
    got = torch.load(os.path.join(four, "four.pt"), weights_only=True)
    res["alone"] = alone
    return dict(two=res, four=dict(want=want, want_metrics=metrics,
                                   got=got))


@pytest.fixture(scope="module")
def two_ranks(launched):
    return launched["two"]


@pytest.fixture(scope="module")
def four_ranks(launched):
    return launched["four"]


@pytest.mark.parametrize("case", TWO_CASES)
def test_two_ranks_equal_the_one_process_step(two_ranks, case):
    res = two_ranks[case]
    assert res["ok"], res
    if "zero" in case:
        # each rank's moments: 1/dp of every ZeRO-split leaf
        assert res["zero_split"] > 0
        assert res["moment_elems"] * 2 <= res["moment_whole"], res
    if case in ("dp2_zero_scaledadam", "tp2_full"):
        # each step's update on the same gradients, and the state at the
        # end (limits and readings in the worker)
        assert res["update_err"] <= 1e-5 and res["delta_err"] <= 1e-4, res
        assert res["scale_err"] <= 2e-3 and res["opt_fro"] <= 5e-3, res
    if case == "dp2_zero_scaledadam":
        assert res["resumed_world2_exact"] and res["restored_world1_exact"]
        assert res["shard_opt_state_exact"]
        assert res["world1_continuation_fro"] <= 1e-5


@pytest.mark.parametrize("run", sorted(TRAINER_RUNS))
def test_trainer_over_a_mesh_equals_one_process(two_ranks, run):
    """A step and a validation of ``Trainer`` (dp 2 with ZeRO-1, tp 2,
    LoRA at tp 2) against one process: the loss and the validation loss
    within 1e-5 relative."""
    best, loss = two_ranks["trainers"]["runs"][run]
    want_best, want_loss = two_ranks["alone"][TRAINER_RUNS[run][1]]
    assert np.isfinite(want_best)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    np.testing.assert_allclose(best, want_best, rtol=1e-5)


# ---------------------------------------------------------------------------
# (d) four ranks against JAX's single-device step
# ---------------------------------------------------------------------------


def _jax_batch(jcfg, rng, n_micro=2, b=8, tx=6, ty=10):
    y = rng.integers(0, jcfg.audio_vocab_size, (n_micro, b, ty))
    y[rng.random(y.shape) < 0.15] = jcfg.special.y_sep
    return {
        "x": rng.integers(3, jcfg.text_vocab_size,
                          (n_micro, b, tx)).astype(np.int32),
        "x_lens": rng.integers(2, tx + 1, (n_micro, b)).astype(np.int32),
        "y": y.astype(np.int32),
        "y_lens": rng.integers(2, ty + 1, (n_micro, b)).astype(np.int32),
        "y_sep_position": np.zeros((n_micro, b), np.int32),
    }


def test_four_ranks_metrics_match_jax(four_ranks):
    got, jm = four_ranks["got"]["metrics"], four_ranks["want_metrics"]
    np.testing.assert_allclose(got["loss"], float(jm.loss), rtol=1e-4)
    np.testing.assert_allclose(got["grad_norm"], float(jm.grad_norm),
                               rtol=1e-3)
    np.testing.assert_allclose(got["ntokens"], float(jm.ntokens), rtol=0)


def test_four_ranks_updated_leaves_match_jax(four_ranks):
    got, want = four_ranks["got"]["params"], four_ranks["want"]
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name].double().numpy()
        w = w.astype(np.float64)
        assert np.linalg.norm(g - w) <= 1e-5 * max(np.linalg.norm(w),
                                                   1e-30), name


def test_four_ranks_split_the_model_and_the_moments(four_ranks):
    got = four_ranks["got"]
    assert got["tp_split"] > 0 and got["zero_split"] > 0
    assert got["moment_elems"] * 2 <= got["moment_whole"]
