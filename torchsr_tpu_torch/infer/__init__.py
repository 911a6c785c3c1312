"""Inference: tiled upscaling, the ``test`` runner and the HTTP server."""
