from .pipeline import BinTokenDataset, SyntheticLM, make_pipeline
