from .format import YalmFile, read_yalm, write_yalm

__all__ = ["YalmFile", "read_yalm", "write_yalm"]
