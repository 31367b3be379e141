"""RNN-T joint and loss (counterpart of ``apex_tpu.contrib.transducer``)."""

from apex_tpu_torch.contrib.transducer.transducer import (
    TransducerJoint,
    TransducerLoss,
    pack_joint_output,
    transducer_joint,
    transducer_loss,
)

__all__ = ["TransducerJoint", "TransducerLoss", "transducer_joint",
           "transducer_loss"]
