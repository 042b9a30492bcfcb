from .pipeline import DataConfig, ShardedLoader, SyntheticCorpus, loader_for_model

__all__ = ["DataConfig", "ShardedLoader", "SyntheticCorpus", "loader_for_model"]
