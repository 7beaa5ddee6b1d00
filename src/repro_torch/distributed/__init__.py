"""Distribution on ``torch.distributed`` (counterpart of
``repro.distributed``): sharding rules and placement on DTensor, int8
error-feedback gradient compression, and GPipe pipelining."""
