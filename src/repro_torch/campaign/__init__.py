# Port of src/repro/campaign/__init__.py: the reference's names.
"""Durable, fault-tolerant sweep campaigns (manifest / retry / resume).

``run_campaign(space, checkpoint_dir)`` shards a design-space sweep
into checkpointed ``index_range`` units with bounded retry, OOM
splitting and quarantine; ``resume(manifest_path)`` re-dispatches only
what's missing; ``workers=N`` runs shards on N persistent worker
processes with overlapped checkpoint I/O (see
:mod:`repro_torch.campaign.executor`).  Campaigns run on ``device``
(``"cuda"`` unless the caller asks for ``"cpu"``).  See
:mod:`repro_torch.campaign.runner` for the execution model,
:mod:`repro_torch.campaign.manifest` for the on-disk schema and
:mod:`repro_torch.campaign.gc` for directory retention
(``python -m repro_torch.campaign --gc <root> --keep-days N``).
"""
from .executor import (CheckpointWriter, ProcessShardExecutor,
                       SerialShardExecutor, resolve_workers)
from .faults import (CampaignFault, DeterministicFault, FaultSchedule,
                     KillCampaign, KillWorker, OOMFault, ShardTimeout,
                     TransientFault, classify_failure)
from .gc import campaign_status, gc_campaigns
from .manifest import (CampaignIntegrityError, CampaignManifest,
                       CampaignMismatchError, bank_signature,
                       completed_shards, missing_ranges, plan_shards,
                       read_shard, space_signature, write_shard)
from .merge import merge_stream_results, merged_coverage
from .runner import CampaignOptions, resume, run_campaign

__all__ = [
    "CampaignFault", "CampaignIntegrityError", "CampaignManifest",
    "CampaignMismatchError", "CampaignOptions", "CheckpointWriter",
    "DeterministicFault", "FaultSchedule", "KillCampaign", "KillWorker",
    "OOMFault", "ProcessShardExecutor", "SerialShardExecutor",
    "ShardTimeout", "TransientFault", "bank_signature",
    "campaign_status", "classify_failure", "completed_shards",
    "gc_campaigns", "merge_stream_results", "merged_coverage",
    "missing_ranges", "plan_shards", "read_shard", "resolve_workers",
    "resume", "run_campaign", "space_signature", "write_shard",
]
