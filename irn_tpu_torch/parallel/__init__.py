"""Several devices and several processes: the port's counterpart of
:mod:`irn_tpu.parallel` (one process per rank under ``torch.distributed``,
DDP for the train stages)."""
