"""Environment interface for multi-turn / tool-use rollouts (a copy of
``trlx_tpu/online/environment.py``).

Plain reward_fn training scores a finished string; an *environment* is an
interaction loop — the policy observes, generates an action, the world
responds, and reward accrues per turn (observe → generate → act → reward).
The interface is deliberately token-level and tiny:

- :meth:`Environment.reset` returns the initial observation as token ids
  (the prompt the policy generates against);
- :meth:`Environment.step` consumes the policy's action tokens and returns
  the next observation, a scalar reward, and a done flag;
- :meth:`Environment.evaluate` is the optional *stateless* shortcut — a
  per-(prompt, action) score for environments whose reward needs no
  interaction state. It is what lets an environment stand in for a
  reward_fn in single-turn training (``trlx_tpu_torch.train(environment=...)``) and
  what the online collector uses to score fleet-served completions.

:func:`run_environment_rollout` is the generic interaction loop;
:class:`SyntheticEnvironment` is the seeded, fully deterministic test
world (reward = fraction of action tokens equal to a target token) used by
tests, ``scripts/torch_grpo_synthetic.py`` and ``chip_smoke.py``.
"""

import abc
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

GenerateFn = Callable[[List[int]], List[int]]


class Environment(abc.ABC):
    """One episodic, token-level environment (see module docstring)."""

    @abc.abstractmethod
    def reset(self, seed: Optional[int] = None) -> List[int]:
        """Begin an episode; returns the initial observation token ids."""

    @abc.abstractmethod
    def step(self, action: Sequence[int]) -> Tuple[List[int], float, bool]:
        """Consume the policy's action tokens; returns
        ``(next_observation_tokens, reward, done)``."""

    def evaluate(self, prompt: Sequence[int], action: Sequence[int]) -> float:
        """Stateless per-(prompt, action) score, when the environment's
        reward does not depend on interaction state. Environments that only
        make sense as a loop leave this unimplemented and train through the
        collector's environment path instead."""
        raise NotImplementedError(
            f"{type(self).__name__} has no stateless evaluate(); "
            f"use run_environment_rollout for multi-turn reward"
        )


def run_environment_rollout(
    env: Environment,
    generate_fn: GenerateFn,
    max_turns: int = 4,
    seed: Optional[int] = None,
) -> Tuple[List[int], List[int], float]:
    """The observe → generate → act → reward loop.

    ``generate_fn`` maps the running transcript (all tokens so far) to the
    next action's tokens. Returns ``(initial_prompt, action_trace,
    episode_return)`` — the initial observation, every action token in
    order, and the summed reward: exactly the (prompt, completion, score)
    triple the online buffer stores.
    """
    obs = list(env.reset(seed=seed))
    prompt = list(obs)
    transcript = list(obs)
    actions: List[int] = []
    episode_return = 0.0
    for _ in range(max_turns):
        action = list(generate_fn(transcript))
        obs, reward, done = env.step(action)
        episode_return += float(reward)
        actions.extend(action)
        transcript.extend(action)
        transcript.extend(obs)
        if done:
            break
    return prompt, actions, episode_return


class SyntheticEnvironment(Environment):
    """Seeded deterministic test world over a small token alphabet.

    Each episode draws a random prompt of ``prompt_len`` tokens from the
    seeded stream; the reward of an action is the fraction of its tokens
    equal to ``target_token`` — stateless, so :meth:`evaluate` is exact and
    a policy improves by emitting the target more often (the measurable
    learning signal the e2e soak asserts on). Episodes run ``max_turns``
    turns; ``done`` after the last.
    """

    def __init__(
        self,
        vocab_size: int = 16,
        prompt_len: int = 4,
        target_token: int = 1,
        max_turns: int = 1,
        seed: int = 0,
    ):
        if not 0 <= target_token < vocab_size:
            raise ValueError(
                f"target_token {target_token} outside vocab [0, {vocab_size})"
            )
        self.vocab_size = int(vocab_size)
        self.prompt_len = int(prompt_len)
        self.target_token = int(target_token)
        self.max_turns = int(max_turns)
        self._base_seed = int(seed)
        self._episodes = 0
        self._rng = np.random.default_rng(self._base_seed)
        self._turn = 0

    def reset(self, seed: Optional[int] = None) -> List[int]:
        if seed is None:
            # deterministic stream: episode i always draws the same prompt
            seed = self._base_seed + self._episodes
        self._episodes += 1
        self._rng = np.random.default_rng(int(seed))
        self._turn = 0
        return self._rng.integers(0, self.vocab_size, size=self.prompt_len).tolist()

    def step(self, action: Sequence[int]) -> Tuple[List[int], float, bool]:
        self._turn += 1
        reward = self._action_reward(action)
        done = self._turn >= self.max_turns
        obs = (
            []
            if done
            else self._rng.integers(0, self.vocab_size, size=self.prompt_len).tolist()
        )
        return obs, reward, done

    def evaluate(self, prompt: Sequence[int], action: Sequence[int]) -> float:
        return self._action_reward(action)

    def _action_reward(self, action: Sequence[int]) -> float:
        action = list(action)
        if not action:
            return 0.0
        hits = sum(1 for t in action if int(t) == self.target_token)
        return hits / len(action)


def environment_reward_fn(env: Environment):
    """Adapt a stateless-scorable environment into a trlx reward_fn.

    The returned callable has the trainer's reward signature
    ``fn(samples, prompts, outputs, tokenizer=..., **meta)`` and scores each
    (prompt, output) pair through :meth:`Environment.evaluate` after
    re-encoding the decoded strings. Exact for single-turn environments;
    multi-turn reward needs the interaction loop (the collector's
    :meth:`~trlx_tpu_torch.online.collector.PreferenceCollector.collect_environment`).
    """

    def reward_fn(samples, prompts, outputs, tokenizer=None, **kwargs):
        if tokenizer is None:
            raise ValueError("environment_reward_fn needs the tokenizer kwarg")
        scores = []
        for prompt, output in zip(prompts, outputs):
            p_ids = tokenizer.encode(prompt)
            a_ids = tokenizer.encode(output)
            scores.append(float(env.evaluate(p_ids, a_ids)))
        return scores

    return reward_fn
