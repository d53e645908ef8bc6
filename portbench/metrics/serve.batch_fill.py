"""serve.batch_fill: requests per micro-batch over max_batch (readers.batch_fill)."""
from portbench.readers import batch_fill as read  # noqa: F401
