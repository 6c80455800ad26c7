"""Hand-written CUDA kernels, each beside its plain PyTorch version.

A wrapper in ``<kernel>/ops.py`` runs the plain version for a tensor on the
CPU and launches the kernel for a tensor on the CUDA device (or raises).
"""


def launch_counters():
    """{name: wrapper} of every kernel wrapper; each counts its launches
    in its ``launches`` attribute."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.history_merge.ops import history_merge
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    return {"decode_attention": decode_attention,
            "flash_attention": flash_attention,
            "history_merge": history_merge, "ssd_scan": ssd_scan}
