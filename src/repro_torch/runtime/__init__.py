from .trainer import GeoTrainer, TrainerConfig

__all__ = ["GeoTrainer", "TrainerConfig"]
