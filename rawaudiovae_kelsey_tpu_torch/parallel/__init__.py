from rawaudiovae_kelsey_tpu_torch.parallel.step import (  # noqa: F401
    build_eval_step,
    build_train_step,
    make_loss_fn,
    noise_seed,
)
