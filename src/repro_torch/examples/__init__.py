"""The port's counterparts of the repository's ``examples/``: entry points
over the public API, each run as ``python -m repro_torch.examples.<name>``.

* ``conv_acceleration`` — the paper end to end: the §5.2 layer through
  ``ConvCore``, the cycle model, the layer's time on the card, the int8
  network programs, ``ConvNetEngine`` and QAT;
* ``serve_batched``     — ``ServingEngine`` over a request stream, float
  or w8 with the int8 KV cache;
* ``quickstart``        — a tiny llama trained, then sampled greedily;
* ``train_llama_tiny``  — ``Trainer`` with checkpoints, injected failures
  and the straggler monitor.

Each has ``main(argv=None)``, which takes the example's flags plus
``--device`` (default: the card, raising where there is none) and returns
the figures it prints as a dict."""
