"""python -m origami_tpu_torch.batch.remote — remote corpus runner CLI."""

from origami_tpu_torch.batch.remote.runner import main

if __name__ == "__main__":
    main()
