"""serve.batch_run_s: the median micro-batch, from the batcher taking it to the answers on
the host (spans.batch_run_s)."""
from portbench.spans import batch_run_s as read  # noqa: F401
