"""dit_int8_roofline: the least time the DiT blocks' work of the traced
request needs (from its CFM calls' real chunks, frames, Euler steps and the
widths: the six int8 matmuls and attention, bench_port/flops/dit.py) over
the device time of the kernels that do it in the trace, in %. The kernels
counted: K2 and K4's GEMM `qdense_wgmma_kernel`, K3 `qkv_rope_wgmma_kernel`,
K5 `flash_attn_wgmma_kernel`, and their helpers `row_quant_kernel` and
`v_quant_kernel` (csrc/qmatmul.cu, csrc/qflash.cu)."""

KERNELS = r"\b(qdense_wgmma_kernel|qkv_rope_wgmma_kernel|flash_attn_wgmma_kernel|row_quant_kernel|v_quant_kernel)\b"


def read(run):
    from bench_port.flops import dit
    from bench_port.flops.peaks import bound_s

    r, rec = run.reading, run.traced
    if r is None or not r.matched or rec is None or "cfm_batch" not in rec:
        return None
    c, cfm = run.cfg["s2"], run.cfg["cfm"]
    least = 0.0
    for bs, _ in rec["cfm_batch"]:
        ops, nbytes = dit.block(c, bs, cfm["t_chunk"])
        least += cfm["sample_steps"] * c["cfm_dit_depth"] * bound_s(ops, nbytes, run.cfg["precision"]["dit_blocks"])
    device_s = r.kernel_s(KERNELS)
    return 100.0 * least / device_s if device_s > 0 else None
