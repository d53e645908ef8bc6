"""serve.queue_wait_p95: the 95th percentile of the requests' waits in the batcher's queue
(spans.queue_wait_p95)."""
from portbench.spans import queue_wait_p95 as read  # noqa: F401
