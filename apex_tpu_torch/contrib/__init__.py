"""apex_tpu_torch.contrib: the specialized modules of ``apex_tpu.contrib``,
ported one at a time.  Ported so far: :mod:`.openfold_triton` (the
Evoformer attention core over the pair-bias attention kernels,
``LayerNormSmallShapeOptImpl`` and ``FusedAdamSWA``), :mod:`.clip_grad`
(``clip_grad_norm`` and ``clip_grad_norm_`` on the multi-tensor kernels),
:mod:`.optimizers` (the ZeRO-2 ``DistributedFusedAdam`` and
``DistributedFusedLAMB``) and :mod:`.halo` (halo exchange, the spatially
split convolution and bottleneck)."""
