"""Serving export of the port: ``torch.export`` artifacts and their loader."""

from .export import ServingModel, export_classifier, export_segmentor, save_artifact

__all__ = ["ServingModel", "export_classifier", "export_segmentor", "save_artifact"]
