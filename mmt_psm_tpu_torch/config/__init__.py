from .defaults import get_cfg
from .node import ConfigNode, load_yaml

__all__ = ["ConfigNode", "get_cfg", "load_yaml"]
