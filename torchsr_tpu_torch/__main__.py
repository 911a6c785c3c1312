"""``python -m torchsr_tpu_torch`` entrypoint."""

from torchsr_tpu_torch.cli import main

if __name__ == "__main__":
    main()
