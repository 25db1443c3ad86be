"""The port's models: the dense and MoE transformer LMs (layers, attention,
the MoE layer, the model) and the ColBERTer encoder."""
