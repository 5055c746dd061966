"""The CLI entry of the port: the counterpart of scripts/run_contexture.py.

    python -m contexture_nerf_tpu_torch.run_contexture \
        --config_path=configs/text_guided/spot_quick_test.yaml \
        [--section.key=value | --section.key value ...]

Paints the config's mesh on the card (`ConTEXTure.paint`: prepare_sds, the
SDS loop, the turntable eval and the exported mesh, under
log.exp_root/log.exp_name), or with --log.eval_only=true runs only
`full_eval`. Random towers from optim.seed; the towers of local diffusers
snapshots named by the config (guide.zero123plus_path, controlnet_path,
diffusion_name, inpaint_model_path; guide.concept_path for a
textual-inversion concept) load from disk instead.

On several GPUs, started by torchrun:

    torchrun --nproc_per_node=N -m contexture_nerf_tpu_torch.run_contexture \
        --config_path=... --optim.data_parallel=on \
        [--optim.tensor_parallel=K | --optim.sequence_parallel=K]

With torchrun's environment (RANK and WORLD_SIZE) set, the default group
starts first: NCCL on cuda:LOCAL_RANK, or gloo when the CPU is asked for
(parallel/mesh.py `init_from_env`). Rank 0 writes the run's files.
Without that environment the CLI runs in this process alone.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional

from contexture_nerf_tpu_torch.core.config import load_config
from contexture_nerf_tpu_torch.parallel.mesh import init_from_env
from contexture_nerf_tpu_torch.training.trainer import ConTEXTure


def main(argv: Optional[List[str]] = None, device="cuda",
         tiny_models: bool = False) -> ConTEXTure:
    """Load the config from argv (sys.argv[1:] when None), build the run on
    `device` and paint it (or evaluate it with log.eval_only). Under
    torchrun's environment the default group starts first, unless it has
    already; the rank's device replaces `device`. Returns the run."""
    import torch.distributed as dist

    cfg = load_config(argv)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ \
            and not dist.is_initialized():
        device = init_from_env(device)
    trainer = ConTEXTure(cfg, tiny_models=tiny_models, device=device)
    if cfg.log.eval_only:
        trainer.full_eval()
    else:
        trainer.paint()
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
