from .ppyolo import PPYOLO

__all__ = ["PPYOLO"]
