"""HTTP connectors (port of ``pathway_tpu/io/http``)."""

from __future__ import annotations

from pathway_tpu_torch.io.http._json_server import JsonServer, Reply, Request
from pathway_tpu_torch.io.http._server import EndpointDocumentation, PathwayWebserver, rest_connector

__all__ = ["EndpointDocumentation", "JsonServer", "PathwayWebserver", "Reply", "Request", "rest_connector"]
