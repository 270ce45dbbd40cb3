"""Tiered ontology storage under the serve registry: the hot (resident)
/ warm (host-RAM packed state) / cold (compressed, checksummed disk
spill) hierarchy and its traffic-driven promotion policy."""

from distel_tpu_torch.serve.storage.tiers import TierTraffic

__all__ = ["TierTraffic"]
