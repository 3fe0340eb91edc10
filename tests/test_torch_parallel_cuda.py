"""The mesh's step on a card: NCCL at world size 1, on 127.0.0.1 and a free
port, ``make_mesh(dp=1, tp=1)`` with ZeRO-1 on, one full-model ScaledAdam
step of two micro-batches on the ``test`` preset in f32 through the mesh's
step, bit-equal to the plain step from the same state: the loss and
metrics, every gradient leaf and every updated leaf. This module imports
no JAX; run it on the card with

    python -m pytest -o addopts= --noconftest tests/test_torch_parallel_cuda.py

Without a card every test skips.
"""

import socket

import numpy as np
import pytest
import torch

from t5gemma_tts_tpu_torch import parallel
from t5gemma_tts_tpu_torch.config import tiny_voice_config
from t5gemma_tts_tpu_torch.models import voice
from t5gemma_tts_tpu_torch.train import optim, train_step
from t5gemma_tts_tpu_torch.utils.tree import leaves_with_path

pytestmark = pytest.mark.cuda


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (NCCL runs on cards only)")
    return torch.device("cuda")


def _port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _equal(a, b) -> bool:
    la, lb = list(leaves_with_path(a)), list(leaves_with_path(b))
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))


def test_nccl_world_one_mesh_step_is_bit_equal_to_the_plain_step():
    import torch.distributed as dist

    _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = parallel.init_distributed(
        "cuda", init_method=f"tcp://127.0.0.1:{_port()}")
    try:
        mesh = parallel.make_mesh(dp=1, tp=1)
        cfg = tiny_voice_config()
        ocfg = optim.ScaledAdamConfig(clipping_update_period=4)
        rng = np.random.default_rng(0)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in dict(
            x=rng.integers(3, 500, (2, 2, 12)).astype(np.int32),
            x_lens=rng.integers(4, 13, (2, 2)).astype(np.int32),
            y=rng.integers(0, 128, (2, 2, 20)).astype(np.int32),
            y_lens=rng.integers(5, 21, (2, 2)).astype(np.int32),
            y_sep_position=np.zeros((2, 2), np.int32)).items()}
        params = voice.init_params(0, cfg, dev)
        lr = torch.tensor(0.01, device=dev)

        def forward(p, mb):
            return voice.forward(p, cfg, mb)

        g0, s0 = train_step.accumulate_grads(params, batch, forward)
        p0, _, m0 = train_step.apply_grads(
            params, optim.init(params, ocfg), g0, s0, lr, ocfg)

        specs = parallel.param_specs(params, cfg, 1)
        local = parallel.shard_params(params, mesh, specs)
        layout = parallel.Layout(mesh, specs, local, zero=True)
        g1, s1 = train_step.accumulate_grads(local, batch, forward, mesh)
        p1, _, m1 = train_step.apply_grads(
            local, optim.init(local, ocfg, layout), g1, s1, lr, ocfg, layout)

        assert dist.get_backend() == "nccl"
        assert _equal(g1, g0) and _equal(p1, p0)
        for f in m0._fields:
            assert torch.equal(getattr(m1, f), getattr(m0, f)), f
    finally:
        dist.destroy_process_group()
