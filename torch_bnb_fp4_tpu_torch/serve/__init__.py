"""Continuous-batching engine, its HTTP server and multi-process serving."""

from .engine import Completion, Engine, EngineConfig, Request, prompt_lookup_draft
from .multihost import MultihostEngineServer, follow
from .server import EngineServer

__all__ = ["Completion", "Engine", "EngineConfig", "EngineServer", "MultihostEngineServer", "Request", "follow",
           "prompt_lookup_draft"]
