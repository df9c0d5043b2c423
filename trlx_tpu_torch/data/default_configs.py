"""Canned default configs (counterpart of ``trlx_tpu/data/default_configs.py``):
PPO, GRPO, ILQL, SFT and RFT."""

from trlx_tpu_torch.data.configs import (
    MeshConfig,
    ModelConfig,
    OptimizerConfig,
    SchedulerConfig,
    TokenizerConfig,
    TrainConfig,
    TRLConfig,
)
from trlx_tpu_torch.methods.grpo import GRPOConfig
from trlx_tpu_torch.methods.ilql import ILQLConfig
from trlx_tpu_torch.methods.ppo import PPOConfig
from trlx_tpu_torch.methods.rft import RFTConfig
from trlx_tpu_torch.methods.sft import SFTConfig


def default_ppo_config() -> TRLConfig:
    return TRLConfig(
        train=TrainConfig(
            seq_length=1024,
            epochs=100,
            total_steps=10000,
            batch_size=32,
            checkpoint_interval=10000,
            eval_interval=100,
            pipeline="PromptPipeline",
            trainer="PPOTrainer",
        ),
        model=ModelConfig(model_path="lvwerra/gpt2-imdb", num_layers_unfrozen=2),
        tokenizer=TokenizerConfig(tokenizer_path="gpt2", truncation_side="right"),
        optimizer=OptimizerConfig(
            name="adamw", kwargs=dict(lr=3e-5, betas=(0.9, 0.95), eps=1e-8, weight_decay=1e-6)
        ),
        scheduler=SchedulerConfig(name="cosine_annealing", kwargs=dict(T_max=10000, eta_min=3e-5)),
        method=PPOConfig(
            name="PPOConfig",
            num_rollouts=128,
            chunk_size=128,
            ppo_epochs=4,
            init_kl_coef=0.001,
            target=None,
            horizon=10000,
            gamma=1.0,
            lam=0.95,
            cliprange=0.2,
            cliprange_value=0.2,
            vf_coef=1.0,
            scale_reward="ignored",
            ref_mean=None,
            ref_std=None,
            cliprange_reward=10,
            gen_kwargs=dict(max_new_tokens=40, top_k=0, top_p=1.0, do_sample=True),
        ),
        mesh=MeshConfig(),
    )


def default_ilql_config() -> TRLConfig:
    return TRLConfig(
        train=TrainConfig(
            seq_length=64,
            batch_size=128,
            epochs=100,
            total_steps=1000,
            checkpoint_interval=1000,
            eval_interval=100,
            pipeline="PromptPipeline",
            trainer="ILQLTrainer",
        ),
        model=ModelConfig(model_path="gpt2", num_layers_unfrozen=-1),
        tokenizer=TokenizerConfig(tokenizer_path="gpt2", truncation_side="right"),
        optimizer=OptimizerConfig(
            name="adamw", kwargs=dict(lr=5e-5, betas=(0.9, 0.95), eps=1e-8, weight_decay=1e-6)
        ),
        scheduler=SchedulerConfig(name="cosine_annealing", kwargs=dict(T_max=1000, eta_min=5e-5)),
        method=ILQLConfig(
            name="ILQLConfig",
            tau=0.7,
            gamma=0.99,
            cql_scale=0.1,
            awac_scale=1,
            alpha=0.001,
            beta=0,
            steps_for_target_q_sync=5,
            two_qs=True,
            gen_kwargs=dict(max_new_tokens=56, top_k=20, beta=4.0, temperature=1.0),
        ),
        mesh=MeshConfig(),
    )


def default_sft_config() -> TRLConfig:
    return TRLConfig(
        train=TrainConfig(
            seq_length=1024,
            epochs=100,
            total_steps=1000,
            batch_size=8,
            checkpoint_interval=10000,
            eval_interval=100,
            pipeline="PromptPipeline",
            trainer="SFTTrainer",
        ),
        model=ModelConfig(model_path="gpt2", num_layers_unfrozen=-1),
        tokenizer=TokenizerConfig(tokenizer_path="gpt2", truncation_side="right"),
        optimizer=OptimizerConfig(
            name="adamw", kwargs=dict(lr=1e-5, betas=(0.9, 0.95), eps=1e-8, weight_decay=1e-6)
        ),
        scheduler=SchedulerConfig(name="cosine_annealing", kwargs=dict(T_max=1000, eta_min=1e-5)),
        method=SFTConfig(name="SFTConfig", gen_kwargs=dict(max_new_tokens=32)),
        mesh=MeshConfig(),
    )


def default_grpo_config() -> TRLConfig:
    """Critic-free group-relative PPO. Same optimizer / model surface as
    :func:`default_ppo_config`; the method swaps to :class:`GRPOConfig`
    (group-normalized advantages, no value loss) and generation samples —
    groups need diverse completions."""
    config = default_ppo_config()
    return config.evolve(
        method=GRPOConfig(
            name="GRPOConfig",
            num_rollouts=128,
            chunk_size=128,
            group_size=4,
            ppo_epochs=4,
            init_kl_coef=0.001,
            target=None,
            horizon=10000,
            gamma=1.0,
            cliprange=0.2,
            scale_reward="ignored",
            cliprange_reward=10,
            gen_kwargs=dict(max_new_tokens=40, top_k=0, top_p=1.0, do_sample=True),
        ).to_dict(),
        train={"trainer": "GRPOTrainer"},
    )


def default_rft_config() -> TRLConfig:
    config = default_sft_config()
    return config.evolve(
        method=RFTConfig(name="RFTConfig").to_dict(),
        train={"trainer": "RFTTrainer"},
    )
