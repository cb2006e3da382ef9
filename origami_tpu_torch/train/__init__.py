"""origami_tpu_torch.train — training on the card: trainers, checkpoints.

Port of origami_tpu/train:

segment     tile datasets, warp augmentation (the remap kernel), U-Net
            trainer, distillation, the `gen`/`train` CLI
ocr         CTC recognizer trainer
checkpoint  model and optimizer state in step directories
bootstrap   k-fold ensembles, students, the recognizer's pool training
"""
