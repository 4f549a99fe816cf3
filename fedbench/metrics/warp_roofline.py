"""warp_roofline (%): B1, the weak view's warp and normalize kernel
(``fused_warp_kernel`` of ``fedmlp_tpu_torch/csrc/fused_warp.cu``), as a
share of its roofline. The least time is its bytes over the card's peak
bandwidth: each view image's u8 source [S, S, 3], its shear parameters
[3, 3] f32 and flip byte read once and its f32 view [3, S, S] written once,
for every view image the traced round makes; its
operations (a few a byte) bind less. Divided by the kernel's device time in
the trace. No kernel of that name in the trace, or another count of its
launches than the program's counter gives, reads nothing. Moves
``train_img_per_s``."""

KERNEL = "fused_warp_kernel"


def view_bytes(images: int, side: int) -> int:
    """Bytes that ``images`` weak views of side ``side`` read and write."""
    return images * (side * side * 3 * (1 + 4) + 9 * 4 + 1)


def read(rec: dict):
    w = rec.get("warp")
    ops = [(s, e) for n, s, e, _l in rec["ops"] if KERNEL in n]
    if not w or not ops or len(ops) != w["launches"]:
        return None
    seconds = sum(e - s for s, e in ops) / 1e9
    bound = view_bytes(w["images"], w["side"]) / rec["peak_bytes_per_s"]
    return 100.0 * bound / seconds
