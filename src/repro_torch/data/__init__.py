from . import loader, synthetic

__all__ = ["loader", "synthetic"]
