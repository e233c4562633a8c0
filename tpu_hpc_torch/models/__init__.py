"""tpu_hpc_torch.models: Llama-2 (``llama2``) and its pipelined forms
(``pipeline_transformer``, ``llama_pp``), the weather and vision models
(``unet``, ``vit``, ``resnet``; the shared BatchNorm and conv layers in
``resnet``), their losses (``losses``) and the synthetic datasets
(``datasets``)."""
