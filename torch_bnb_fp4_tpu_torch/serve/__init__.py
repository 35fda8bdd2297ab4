"""Continuous-batching engine and its HTTP server."""

from .engine import Completion, Engine, EngineConfig, Request, prompt_lookup_draft
from .server import EngineServer

__all__ = ["Completion", "Engine", "EngineConfig", "EngineServer", "Request", "prompt_lookup_draft"]
