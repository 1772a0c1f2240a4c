"""What one PowerSGD round moves for a model, worked out on the CPU.

    python3 -m dalle_tpu_torch.plan_powersgd [--preset flagship] [--rank 4]

Builds the model's parameter shapes on the meta device (no weights), lists
its gradient leaves in the wire order (``params.jax_leaf_names``), and
plans them with :meth:`~dalle_tpu_torch.swarm.powersgd.PowerSGDCompressor
.plan`: the planned matrices' P and Q factor elements, the raw tail, and
the fp16 payload of the P round and of the Q round (factors and tail),
beside the u8 gradient round's payload for the same leaves (a 256-element
block costs 256 codes and a 4-byte scale). Frame headers and signatures
are not counted. One JSON line.
"""

from __future__ import annotations

import argparse
import json


def plan_bytes(cfg, rank: int) -> dict:
    import torch

    from dalle_tpu_torch.models.dalle import DALLE
    from dalle_tpu_torch.params import jax_leaf_names
    from dalle_tpu_torch.swarm.powersgd import PowerSGDCompressor

    with torch.device("meta"):
        model = DALLE(cfg)
    params = dict(model.named_parameters())
    leaves = [params[n] for n in jax_leaf_names(cfg)]
    plans = PowerSGDCompressor(rank=rank).plan(leaves)
    planned = {p.index for p in plans}
    p_elems = sum(p.m for p in plans) * rank
    q_elems = sum(p.n for p in plans) * rank
    tail = sum(leaves[i].numel() for i in range(len(leaves))
               if i not in planned)
    total = sum(t.numel() for t in leaves)
    return dict(leaves=len(leaves), planned=len(plans),
                planned_elements=total - tail, tail_elements=tail,
                p_elements=p_elems, q_elements=q_elems,
                p_round_bytes=2 * p_elems,
                q_round_bytes=2 * (q_elems + tail),
                u8_round_bytes=total + 4 * -(-total // 256),
                total_elements=total)


def main() -> int:
    from dalle_tpu_torch.cli import MODEL_PRESETS
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--preset", default="flagship",
                        choices=sorted(MODEL_PRESETS))
    parser.add_argument("--rank", type=int, default=4)
    args = parser.parse_args()
    cfg = MODEL_PRESETS[args.preset]()
    print(json.dumps(dict(preset=args.preset, rank=args.rank,
                          **plan_bytes(cfg, args.rank))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
