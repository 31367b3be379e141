"""apex_tpu_torch.utils: flat-buffer packing and tree math (counterpart of
``apex_tpu.utils``, the parts the packed optimizers use)."""
