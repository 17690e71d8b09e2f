"""How far a bf16 kernel output lies from its plain version.

Two measures, each a number the checks hold to a stated limit:

- :func:`ulp_error`: the largest element error in bf16 ulps of the plain
  value (one ulp of a bf16 ``x`` is ``2 ** (floor(log2 |x|) - 7)``),
  never below ``floor``. A kernel that rounds once, at the output, after
  summing in float32 in another order flips that rounding at most: one
  ulp.
- :func:`row_rel_l2`: the largest relative L2 error of one output row
  (every head of one query of one slot). A kernel that follows a plain
  version's intermediate bf16 roundings (the ragged kernel's scores,
  probabilities and partial sums) flips a few of them: sparse errors of a
  few ulps of a score or a partial, which are many ulps of a small output
  element but a small share of its row. A kernel that walks the wrong
  positions (a block dropped or read twice) moves the whole row.
"""

from __future__ import annotations

import torch


def ulp_error(out: torch.Tensor, ref: torch.Tensor,
              floor: float = 2.0 ** -8) -> float:
    """max |out - ref| in bf16 ulps of ``max(|ref|, floor)``, element by
    element. NaN if either holds one."""
    mag = ref.float().abs().clamp_min(floor)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((out.float() - ref.float()).abs() / ulp).max().item()


def row_rel_l2(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max over rows of ||out - ref|| / ||ref||, a row being the trailing
    (Hq, D) of a (B, G, Hq, D) output. NaN if either holds one."""
    diff = (out.float() - ref.float()).flatten(2).norm(dim=-1)
    return (diff / ref.float().flatten(2).norm(dim=-1)).max().item()
