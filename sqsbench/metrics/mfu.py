"""The whole step's share (%) of the card's bf16 peak: the FLOPs the
window's prefills, draft decodes and verify extends need, from shapes
(``harness.roofline``), over the traced window's seconds times 989
TFLOP/s."""
from harness import readers, roofline


def read(run):
    if not run.red:
        return None
    return 100.0 * readers.window_flops(run) / (
        run.red["window_s"] * roofline.PEAK_BF16_FLOPS)
