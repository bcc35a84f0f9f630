from .engine import QueryEngine, QueryHandle
from .service import ServiceConfig, ServingService, ServingTicket
