"""The CLI entry of the port: the counterpart of scripts/run_contexture.py.

    python -m contexture_nerf_tpu_torch.run_contexture \
        --config_path=configs/text_guided/spot_quick_test.yaml \
        [--section.key=value | --section.key value ...]

Paints the config's mesh on the card (`ConTEXTure.paint`: prepare_sds, the
SDS loop, the turntable eval and the exported mesh, under
log.exp_root/log.exp_name), or with --log.eval_only=true runs only
`full_eval`. Random towers from optim.seed.
"""

from __future__ import annotations

import sys
from typing import List, Optional

from contexture_nerf_tpu_torch.core.config import load_config
from contexture_nerf_tpu_torch.training.trainer import ConTEXTure


def main(argv: Optional[List[str]] = None, device="cuda",
         tiny_models: bool = False) -> ConTEXTure:
    """Load the config from argv (sys.argv[1:] when None), build the run on
    `device` and paint it (or evaluate it with log.eval_only). Returns the
    run."""
    cfg = load_config(argv)
    trainer = ConTEXTure(cfg, tiny_models=tiny_models, device=device)
    if cfg.log.eval_only:
        trainer.full_eval()
    else:
        trainer.paint()
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
