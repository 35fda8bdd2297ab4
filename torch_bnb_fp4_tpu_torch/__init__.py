"""PyTorch/CUDA port of torch_bnb_fp4_tpu for NVIDIA Hopper (sm_90a).

FP4 weight-only serving of Llama/Mistral-family decoders and Mixtral's
sparse mixture of experts: pair-K packed linears (ops/format.py),
hand-written CUDA kernels for the pair-K matmuls (and their expert forms),
the int8 prefill shadow and attention (csrc/, bound in ops/), the decoder
(models/), a greedy continuous-batching engine with its HTTP server and CLI
(serve/: ``python -m torch_bnb_fp4_tpu_torch.serve``), packed checkpoints in
the JAX package's format (convert/checkpoint.py) and a weight carrier from
the JAX package's layout (convert/from_numpy.py).  Entry points default to
``device="cuda"`` and raise without a card unless given ``device="cpu"``.
"""
