from repro_torch.data.pipeline import SyntheticLM, ViterbiStream, make_data_iter

__all__ = ["SyntheticLM", "ViterbiStream", "make_data_iter"]
