"""Greedy continuous-batching engine and its HTTP server."""

from .engine import Completion, Engine, EngineConfig, Request
from .server import EngineServer

__all__ = ["Completion", "Engine", "EngineConfig", "EngineServer", "Request"]
