"""Published peaks of the cards the benchmark reports against (NVIDIA's
data sheets, dense rates without sparsity, at the full power limit). A
card set below its limit runs slower under load; the run prints the
card's name and power limit beside every share of a peak."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "fp32_flops": 67e12,        # outside the tensor cores
        "tf32_flops": 494.7e12,     # tensor cores, dense
        "bf16_flops": 989e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peaks(device_name: str) -> dict:
    """The peaks of the card named `device_name` (an H100 SXM's for any
    other name that holds "H100"); raises for a card it does not know,
    rather than report a share of an unknown peak."""
    if device_name in PEAKS:
        return PEAKS[device_name]
    if "H100" in device_name:
        return PEAKS["NVIDIA H100 80GB HBM3"]
    raise KeyError(f"no published peaks for {device_name!r}")
