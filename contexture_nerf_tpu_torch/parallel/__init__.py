"""Several GPUs: the device mesh (`mesh`), ring attention over a sequence
axis (`ring`) and tensor-parallel towers (`tp`), over torch.distributed;
counterparts of contexture_nerf_tpu/parallel/."""
