"""Job submission: run driver scripts on the cluster, track their lifecycle.

Analog of /root/reference/python/ray/job_submission/ (JobSubmissionClient,
JobStatus) + dashboard/modules/job/job_manager.py (JobManager :431,
JobSupervisor :133): a detached zero-CPU supervisor actor runs the
entrypoint as a subprocess on a cluster node, streams its output into the
GCS KV, and records status transitions there.
"""

from ray_tpu_torch.job_submission.job_manager import (  # noqa: F401
    JobInfo, JobStatus, JobSubmissionClient)

__all__ = ["JobSubmissionClient", "JobStatus", "JobInfo"]
