"""The flash-prefill gate's misses, recomputed through the JAX package.

Over the 40 seeds of ``scripts/kernel_tolerance_sweep.py`` the port's bf16
flash-prefill kernel lands farther than ``chip_smoke.FLASH_TOL`` (3e-2)
from its plain version at five output elements. ``scripts/
flash_gate_cases.py`` recorded them on the card (NVIDIA H100 80GB HBM3,
700 W): the kernel's and the plain version's values, and the inputs the
element depends on (its q row, the K/V rows up to its position), in
``tests/data/flash_gate_cases.npz``. Here, on the CPU, each element goes
through:

- the JAX package's Pallas ``_flash_kernel`` in interpret mode
  (``_pallas_flash``, one block at these lengths): the card kernel's
  value, bit for bit, one bf16 ulp (0.03125 at |x| >= 4) from the JAX
  oracle, so the reference's own kernel misses its oracle at the same
  elements by the same amount;
- the JAX oracle (``gofr_tpu.ops.attention.prefill_attention``) and the
  port's plain version on the CPU: the card plain version's value;
- ``gofr_tpu.ops.pallas.flash_attention`` as the reference serves it: the
  Pallas kernel where S >= 128, the dense oracle below (S 32 is not
  tileable), where the port's kernel gives the Pallas kernel's value.

The gate stays 3e-2.
"""

import importlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gofr_tpu.ops.pallas.flash_attention import _pallas_flash, flash_attention
from gofr_tpu_torch.ops.cuda.flash_attention import flash_attention_plain

jax_attn = importlib.import_module("gofr_tpu.ops.attention")

CASES = np.load(Path(__file__).parent / "data" / "flash_gate_cases.npz")
FLASH_TOL = 3e-2           # chip_smoke.FLASH_TOL


def _bf16(bits):
    return (bits.astype(np.uint32) << 16).view(np.float32)


@pytest.mark.parametrize("case", range(len(CASES["meta"])))
def test_jax_kernel_misses_its_oracle_where_the_port_kernel_does(case):
    seed, _, seq, _, pos, _, col, offset, rows = CASES["meta"][case]
    card_kernel, card_plain = CASES["values"][case]
    kv = _bf16(CASES["kv"][offset:offset + rows])
    # one head: row pos of q, K/V rows 0..pos; the rest is zero, which a
    # causal row pos never reads (masked scores, p = 0 on finite V)
    q = np.zeros((1, seq, 1, 128), np.float32)
    k, v = np.zeros_like(q), np.zeros_like(q)
    q[0, pos, 0] = _bf16(CASES["q"][case])
    k[0, :rows, 0], v[0, :rows, 0] = kv[:, 0], kv[:, 1]
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    block = min(512, seq)

    def at(out):
        return float(np.asarray(out[0, pos, 0, col], np.float32))

    pallas = at(_pallas_flash(jq, jk, jv, True, block, block, True))
    oracle = at(jax_attn.prefill_attention(jq, jk, jv))
    served = at(flash_attention(jq, jk, jv, interpret=True))
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    plain = float(flash_attention_plain(tq, tk, tv)[0, pos, 0, col])
    assert pallas == card_kernel, (seed, pallas, card_kernel)
    assert oracle == plain == card_plain, (seed, oracle, plain, card_plain)
    assert abs(pallas - oracle) > FLASH_TOL
    assert served == (pallas if seq >= 128 else oracle)
