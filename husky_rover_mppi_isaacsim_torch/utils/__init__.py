from .timer import ScopedTimer, block_until_ready, timed

__all__ = ["ScopedTimer", "block_until_ready", "timed"]
