from .batch import BatchDecodePipeline, make_mesh

__all__ = ["BatchDecodePipeline", "make_mesh"]
