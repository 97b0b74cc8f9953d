"""cswin_unet_tpu_torch — CSWin-UNet serving, training and evaluation in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

It sits beside the JAX package ``cswin_unet_tpu``, which stays the
reference: every module here has a counterpart of the same name there, and
the tests hold each one against it on the same weights and inputs. The port
imports ``torch``, never ``jax`` and nothing of ``cswin_unet_tpu`` (it keeps
its own copies of the config, its YAML files and the NIfTI writer).

Layer map (entry point down to the kernels):
  serve       -> cswin_unet_tpu_torch.serve (VolumeServer, watch loop, CLI)
  train       -> cswin_unet_tpu_torch.train (trainer_synapse, SGD + poly LR,
                 CLI: python -m cswin_unet_tpu_torch.train)
  data        -> cswin_unet_tpu_torch.data (Synapse readers, augmentations,
                 threaded loader, device prefetch)
  parallel    -> cswin_unet_tpu_torch.parallel (torch.distributed: one
                 process per GPU under torchrun, DDP, the sharded loader's
                 rank and world, global-batch Dice sums and draws)
  losses      -> cswin_unet_tpu_torch.losses (CE, Dice, Focal, KD)
  eval        -> cswin_unet_tpu_torch.eval (VolumeInferencer, test_single_volume,
                 inference; CLI: python -m cswin_unet_tpu_torch.eval)
  metrics     -> cswin_unet_tpu_torch.metrics (host Dice / HD95: the C++ EDT
                 of utils.native, else scipy) and cswin_unet_tpu_torch.ops.edt
                 (the same on the device)
  profiling   -> cswin_unet_tpu_torch.utils.profiling (span: the serve,
                 infer, train and model layers' ranges on torch.profiler;
                 device_trace, device_busy_ms)
  model       -> cswin_unet_tpu_torch.models (CSwinUnet wrapper, CSWinUNet)
  checkpoint  -> cswin_unet_tpu_torch.utils.checkpoint (the JAX .npz format,
                 JAX <-> torch parameter names and layouts)
  config      -> cswin_unet_tpu_torch.config (the config system, key for key
                 the JAX package's; YAML files in configs/)
  ops         -> cswin_unet_tpu_torch.ops: plain PyTorch compositions
                 (windows, stripe attention, CARAFE, EDT)
  kernels     -> cswin_unet_tpu_torch.ops.cuda: the CSWin block as a chain
                 of CUDA kernels (layernorm, GEMM, stripe attention) with a
                 backward chain of CUDA kernels (CSWinBlockFn), the fused
                 CARAFE kernel, the `pallas` route's stripe attention
                 (CSWinAttentionFn) and the EDT pass, built with nvcc on
                 first use

Each kernel wrapper runs its plain PyTorch version for a tensor on the CPU
and launches its CUDA kernel (or raises) for a tensor on the GPU.
"""

__version__ = "0.1.0"
