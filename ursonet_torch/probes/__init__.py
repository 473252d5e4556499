"""Kernel probes of the port, the counterparts of the JAX package's
`tools/probe_fused_block.py`, `tools/probe_int8_mxu.py`,
`tools/probe_int4_mxu.py`, `tools/probe_pallas_stem.py` and
`tools/probe_actq_wgrad8.py`. Each builds
its operands from a seed, runs its kernel on the card, checks or
records, and prints one JSON line per variant:

    python -m ursonet_torch.probes.fused_block
    python -m ursonet_torch.probes.int8_mma
    python -m ursonet_torch.probes.int4_mma
    python -m ursonet_torch.probes.stem
    python -m ursonet_torch.probes.actq_wgrad8 check|bench
"""
