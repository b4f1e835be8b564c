"""Multi-GPU data parallelism on `torch.distributed`: `mesh` (the ranks),
`pipeline` (the sharded codec) and `dryrun` (its N-rank check).
Counterpart of `mhc_tpu/parallel/`."""
