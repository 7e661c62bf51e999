"""Share (%) of the HBM roofline of K-SQS's top-K search: 4 B a padded
vocabulary entry a row, over its device time in the traced window."""
from harness import readers


def read(run):
    return readers.kernel_roofline(run, "topk_threshold_kernel", 4.0)
