"""host_issue_ms.tiles: the host's time to issue a sampler call's first step
(spans.host_issue_ms)."""
from portbench.spans import host_issue_ms as read  # noqa: F401
