"""The REST control plane: the server and its OpenAPI document."""
