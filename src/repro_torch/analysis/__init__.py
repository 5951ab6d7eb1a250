"""Analysis of the dry run's cells (counterpart of ``repro/analysis``): so far only ``roofline._cache_bytes``."""
