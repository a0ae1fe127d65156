"""recon_roofline: the reconstruction kernel's least time over its device
time in the traced sub-window, in %. The least time of a launch of width
B is the larger of its bytes (`flops.recon_kernel_bytes`, each counted
once) over the card's memory bandwidth and its operations at their least
cost, TF32's tensor-core rate; the launches by width are the program's
counter (`recon_kernel.launch_widths`) over the same sub-window, and the
device time is the trace's, summed over the kernels named below. A trace
in which none of them ran, or whose launches disagree with the counter,
gives nothing."""

from benchmark import flops

# the reconstruction kernel's device function, as the trace names it
# (K1, `csrc/recon_matmul.cu`)
KERNELS = ("recon_matmul_kernel",)


def read(ctx):
    s, rec, peaks = ctx["trace"], ctx["recon"], ctx["peaks"]
    if s is None or rec is None or peaks is None:
        return None
    ops = [(sec, n) for name, sec, n in s["ops"] if any(k in name for k in KERNELS)]
    launches = ctx["launch_widths"]
    if not ops or sum(n for _, n in ops) != sum(launches.values()):
        return None
    least = 0.0
    for b, n in launches.items():
        least += n * max(flops.recon_kernel_bytes(b, rec["K"], rec["Dp"])
                         / peaks["hbm_bytes_per_s"],
                         flops.recon_kernel_flops(b, rec["K"], rec["Dp"])
                         / peaks["tf32_flops"])
    return 100.0 * least / sum(sec for sec, _ in ops)
