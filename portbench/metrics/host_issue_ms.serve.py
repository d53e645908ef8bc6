"""host_issue_ms.serve: the host's time to issue a micro-batch's first step
(spans.host_issue_ms)."""
from portbench.spans import host_issue_ms as read  # noqa: F401
