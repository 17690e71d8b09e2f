"""Training on the card (``parallel/train``) against the port's own CPU
path, and the kernel wrappers' refusal of autograd. Marked ``cuda``: each
test skips itself on a host without a CUDA device. Run them on the GPU
host with ``python -m pytest tests/test_torch_cuda_train.py -q
--noconftest``.

- Each of the three wrappers, called on card tensors of which one
  requires a gradient with grad mode on, raises (its kernel has no
  backward, as the Pallas kernel has none) and launches nothing; the same
  call under ``torch.no_grad()`` launches its kernel once.
- Three ``step_fn`` steps of ``tiny`` at float32 on the card from the
  CPU's initial state track three on the CPU: losses within 1e-5
  relative, count and step equal, params within 1e-5 where the first
  moment, after the first step and after the last, is above 1e-2 of its
  leaf's largest and within 2·lr a step elsewhere (Adam's first steps
  take either sign where a gradient is rounding noise), the moments
  within 1e-4 of their leaf's largest: cuBLAS and the card's reductions
  sum in another order than the CPU (a norm's gradient sums over every
  token).
- ``make_eval_step`` through the flash kernel (head_dim 64, float32)
  launches it once a layer and is within 1e-4 relative of the plain
  eval.
"""

import pytest
import torch

import chip_smoke
from gofr_tpu_torch.models import llama
from gofr_tpu_torch.ops.cuda import decode_attention as decode_mod
from gofr_tpu_torch.ops.cuda import flash_attention as flash_mod
from gofr_tpu_torch.ops.cuda import ragged_paged_attention as ragged_mod
from gofr_tpu_torch.parallel import make_eval_step, make_train_step
from gofr_tpu_torch.utils import tree as tree_util

pytestmark = pytest.mark.cuda

MODS = (flash_mod, ragged_mod, decode_mod)
LR = 3e-4
STEPS = 3


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _launches():
    return chip_smoke.read_launches(MODS)


def test_wrappers_refuse_autograd(cuda):
    for name, fn, args in chip_smoke.grad_refusal_calls(torch, MODS):
        assert torch.is_grad_enabled()
        before = _launches()
        with pytest.raises(RuntimeError, match="no backward"):
            fn(*args)
        assert _launches() == before, name
        with torch.no_grad():
            out = fn(*args)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all(), name
        assert sum(_launches().values()) == sum(before.values()) + 1, name


def _on(tree, device):
    return tree_util.unflatten(tree, {
        key: leaf.to(device) for key, leaf in tree_util.flatten(tree).items()})


def test_train_step_on_the_card_tracks_the_cpu(cuda):
    cfg = llama.config("tiny", dtype=torch.float32)
    init_fn, cpu_step = make_train_step(cfg, learning_rate=LR, device="cpu")
    _, card_step = make_train_step(cfg, learning_rate=LR, device=cuda)
    cpu_state = init_fn(0)
    card_state = _on(cpu_state, cuda)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
    targets = torch.roll(tokens, -1, dims=1)
    firsts = []
    for _ in range(STEPS):
        cpu_state, cpu_loss = cpu_step(cpu_state, tokens, targets)
        card_state, card_loss = card_step(card_state, tokens, targets)
        assert card_loss.device.type == "cuda"
        assert abs(card_loss.item() - cpu_loss.item()) \
            <= 1e-5 * abs(cpu_loss.item())
        firsts.append({k: v.clone() for k, v in tree_util.flatten(
            cpu_state.opt_state[0].mu).items()})
    assert int(card_state.step) == int(cpu_state.step) == STEPS
    assert int(card_state.opt_state[0].count) == STEPS
    got = {k: v.cpu() for k, v in tree_util.flatten(card_state).items()}
    want = tree_util.flatten(cpu_state)

    def settled(mu):
        return mu.abs() > 1e-2 * mu.abs().max()

    for key, ref in want.items():
        delta = (got[key].float() - ref.float()).abs()
        if key.startswith(".params/"):
            leaf = key[len(".params/"):]
            tight = settled(firsts[0][leaf]) & settled(firsts[-1][leaf])
            assert delta[tight].max() <= 1e-5, key
            assert delta.max() <= 2 * LR * STEPS, key
        elif key.startswith(".opt_state/0/"):
            assert delta.max() <= 1e-4 * ref.float().abs().max(), key


def test_eval_through_the_flash_kernel(cuda):
    cfg = llama.config("tiny", dim=128, n_heads=2, n_kv_heads=1,
                       dtype=torch.float32)
    params = llama.init(cfg, 2, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                           device=cuda)
    targets = torch.roll(tokens, -1, dims=1)
    flash_cfg = llama.config("tiny", dim=128, n_heads=2, n_kv_heads=1,
                             dtype=torch.float32, use_flash=True)
    before = flash_mod.launches
    flash_loss = make_eval_step(flash_cfg, device=cuda)(params, tokens,
                                                        targets).item()
    assert flash_mod.launches == before + cfg.n_layers
    plain_loss = make_eval_step(cfg, device=cuda)(params, tokens,
                                                  targets).item()
    assert abs(flash_loss - plain_loss) <= 1e-4 * abs(plain_loss)
