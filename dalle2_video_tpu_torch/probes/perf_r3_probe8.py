"""Flash-forward probe 8 (port of scripts/perf_r3_probe8.py): the r2
control against the fused-denominator forward, at the probe geometry.

Rows:
  1. r2 control: ``ops/flash_variants.r2_fwd`` on q scaled by the caller
     (the scale multiply is in the timed call, as in the JAX probe);
  2. the fused forward: ``ops/flash_mqa.flash_mqa_fwd``;
  3. the fused forward with save_lse (the training forward);
  4. the full VJP through ``ops/flash_mqa.flash_mqa`` (the forward with the
     lse and the backward kernel);
  5. the library yardstick: SDPA with the kv expanded per head.

    python -m dalle2_video_tpu_torch.probes.perf_r3_probe8
"""

from __future__ import annotations

from typing import Dict, List

import torch

from dalle2_video_tpu_torch.ops import flash_mqa as fm
from dalle2_video_tpu_torch.ops import flash_variants as fv
from dalle2_video_tpu_torch.probes import SCALE, inputs, main, run_rows, sdpa_row


def rows(device, card: str) -> List[Dict]:
    q, k, v = inputs(device)

    def vjp():
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        loss = fm.flash_mqa(qg, kg, vg, sm_scale=SCALE).float().sum()
        return torch.autograd.grad(loss, (qg, kg, vg))

    return run_rows([
        dict(name="r3p8_fwd_r2_control", kind="r2 kernel (row 10)",
             fn=lambda: fv.r2_fwd(q * SCALE, k, v)),
        dict(name="r3p8_fwd_fused", kind="fused forward (row 1)",
             fn=lambda: fm.flash_mqa_fwd(q, k, v, sm_scale=SCALE)),
        dict(name="r3p8_fwd_fused_lse", kind="fused forward + save_lse (row 1)",
             fn=lambda: fm.flash_mqa_fwd(q, k, v, sm_scale=SCALE, save_lse=True)),
        dict(name="r3p8_vjp_bwd", kind="full VJP, forward + lse and backward (rows 1 + 2)",
             fn=vjp, iters=5),
        dict(name="r3p8_sdpa", kind="library: SDPA, kv expanded per head",
             fn=sdpa_row(q, k, v)),
    ], q, k, v, card)


if __name__ == "__main__":
    main("perf_r3_probe8", rows)
