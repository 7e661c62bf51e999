"""Share (%) of the HBM roofline of the fused SQS kernel: 12 B a padded
vocabulary entry a row, over its device time in the traced window."""
from harness import readers


def read(run):
    return readers.kernel_roofline(run, "sqs_fused_kernel", 12.0)
