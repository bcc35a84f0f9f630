from .engine import QueryEngine, QueryHandle
